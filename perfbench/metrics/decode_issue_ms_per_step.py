"""The LM decode's host path (``transformer.decode_step`` through the
server's ``_decode``): host time the harness's spans around each decode
call of the measured window take to issue a step's operations, averaged
over its steps."""


def read(run):
    spans = run.window.issue_s
    return sum(spans) / len(spans) * 1e3 if spans else None
