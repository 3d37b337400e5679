"""The whole forward: the measured window's windows a second times a
window's operations at the peak of the precision the configuration states
for each layer (int8 tensor cores, bf16 tensor cores, fp32), in percent of
the card's peak."""


def read(run):
    rate = run.window.rows / run.window.seconds
    return 100.0 * rate * sum(layer.ideal_s_per_row for layer in run.layers)
