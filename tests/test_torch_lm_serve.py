"""The port's ``BatchedServer`` on the shared continuous-batching core.

The six cases of ``tests/test_serve.py`` against the port (queue order,
partial final batches, per-request ``max_new``, determinism, adaptive
slots), on the CPU; then the port's greedy tokens against the reference
server's for the same weights and requests (gemma-2b smoke, fp32).

Greedy decoding is held token for token.  Every step's logits of the port
are held within ``LOGIT_ATOL`` 1e-4 of the reference's (gemma-2b smoke
logits of scale ~2; measured differences ~1e-5, from another BLAS), and the
reference's top-2 logit margin must exceed twice that at every step of
every live slot: a flipped token can then only mean a fault, not a near
tie.  As in the reference, LM decode is not
batch-composition independent, so the same batches are compared, never
different co-batches.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def lm():
    """Smoke-sized gemma config + seeded params on the CPU."""
    cfg = get_config("gemma-2b").smoke()
    return cfg, T.init_params(0, cfg, device="cpu")


def _requests(cfg, n, *, seed=0, max_new=5, cls=Request):
    rng = np.random.default_rng(seed)
    return [
        cls(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, int(rng.integers(3, 12))).astype(np.int32),
            max_new=max_new,
        )
        for i in range(n)
    ]


def _server(lm, **kw):
    cfg, params = lm
    return BatchedServer(cfg, params, device="cpu", **kw)


def test_serve_smoke_decodes_every_request(lm):
    cfg = lm[0]
    done = _server(lm, batch_slots=2).serve(_requests(cfg, 4))
    assert len(done) == 4
    for r in done:
        assert r.out is not None and r.out.dtype == np.int32
        assert len(r.out) == r.max_new
        assert ((0 <= r.out) & (r.out < cfg.vocab)).all()


def test_serve_preserves_queue_order(lm):
    done = _server(lm, batch_slots=3).serve(_requests(lm[0], 7, seed=1))
    assert [r.rid for r in done] == list(range(7))


def test_serve_partial_final_batch_pads_dead_slots(lm):
    # 5 requests into 4 slots: one full block + one 1-live block whose dead
    # slots must be invisible in the results (no rid=-1 leaks, no extras)
    server = _server(lm, batch_slots=4)
    done = server.serve(_requests(lm[0], 5, seed=2))
    assert [r.rid for r in done] == list(range(5))
    assert all(r.rid >= 0 and len(r.out) == r.max_new for r in done)
    assert server.slot_histogram == {4: 2}


def test_serve_single_request_and_respects_per_request_max_new(lm):
    server = _server(lm, batch_slots=4)
    reqs = _requests(lm[0], 3, seed=3)
    reqs[0].max_new = 2
    reqs[2].max_new = 7
    done = server.serve(reqs)
    solo = server.serve(_requests(lm[0], 1, seed=4))
    assert [len(r.out) for r in done] == [2, 5, 7]
    assert len(solo) == 1 and len(solo[0].out) == solo[0].max_new


def test_serve_deterministic_for_identical_batches(lm):
    server = _server(lm, batch_slots=2)
    a = server.serve(_requests(lm[0], 4, seed=5))
    b = server.serve(_requests(lm[0], 4, seed=5))
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.out, rb.out)


def test_serve_adaptive_slots_shrink_tail_blocks(lm):
    server = _server(lm, batch_slots=4, adaptive_slots=True)
    done = server.serve(_requests(lm[0], 7, seed=6))
    assert [r.rid for r in done] == list(range(7))
    assert all(len(r.out) == r.max_new for r in done)
    # 7 requests -> one 4-block, one 2-block, one 1-block: zero dead slots
    assert server.slot_histogram == {4: 1, 2: 1, 1: 1}
    assert server._core.padded_slots == 0


@pytest.mark.parametrize("adaptive", [False, True])
def test_greedy_tokens_equal_reference_server(lm, adaptive):
    cfg, params = lm
    jcfg = jget_config("gemma-2b").smoke()
    np_params = T.params_to_numpy(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jserver = jserve.BatchedServer(jcfg, jparams, batch_slots=4, adaptive_slots=adaptive)
    jlogits, tlogits, live = [], [], []

    def recorded(fn, into):
        def call(*args):
            logits, caches = fn(*args)
            into.append(np.asarray(logits)[:, -1])
            return logits, caches
        return call

    jserver._prefill = recorded(jserver._prefill, jlogits)
    jserver._decode = recorded(jserver._decode, jlogits)
    orig_serve_batch = jserver._serve_batch

    def serve_batch(batch, greedy):
        live.append((len(jlogits), [r.max_new for r in batch]))
        return orig_serve_batch(batch, greedy)

    jserver._serve_batch = serve_batch
    want = jserver.serve(_requests(cfg, 6, seed=7, max_new=8, cls=jserve.Request))
    server = BatchedServer(cfg, params, batch_slots=4, adaptive_slots=adaptive, device="cpu")
    server._prefill = recorded(server._prefill, tlogits)
    server._decode = recorded(server._decode, tlogits)
    got = server.serve(_requests(cfg, 6, seed=7, max_new=8))
    # every token a live slot emits was decided by a margin that no port
    # error within LOGIT_ATOL can flip
    assert len(tlogits) == len(jlogits)
    for first, max_new in live:
        for step in range(max(max_new)):
            want_l, got_l = jlogits[first + step], tlogits[first + step]
            top2 = np.sort(want_l, axis=-1)[:, -2:]
            for i, n in enumerate(max_new):
                if step < n:
                    np.testing.assert_allclose(got_l[i], want_l[i], rtol=0, atol=LOGIT_ATOL)
                    assert top2[i, 1] - top2[i, 0] > 2 * LOGIT_ATOL, (first, step, i)
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.out, w.out)


def test_cli_serves_the_smoke_config_on_the_cpu(capsys):
    done = tserve.main(["--device", "cpu", "--requests", "3", "--max-new", "4"])
    assert [len(r.out) for r in done] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "slot histogram: {4: 1}" in out


def test_full_width_prefill_logits_match_reference_at_one_layer():
    """gemma-2b's published widths, cut to one layer and a 1,024-word
    vocabulary so that the reference runs in seconds, fp32: within the
    archs' 2e-4 (sums of 2,048 and 16,384 products; measured 5.5e-6)."""
    cut = dict(n_layers=1, vocab=1024, param_dtype="float32", act_dtype="float32")
    cfg = get_config("gemma-2b").replace(**cut)
    jcfg = jget_config("gemma-2b").replace(**cut)
    params = T.init_params(0, cfg, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, T.params_to_numpy(params))
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (1, 6)).astype(np.int32)
    got, _ = T.forward_with_cache(params, {"tokens": torch.from_numpy(tok)}, cfg, 8)
    want, _ = JT.forward_with_cache(jparams, {"tokens": jnp.asarray(tok)}, jcfg, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
