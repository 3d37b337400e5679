"""Frozen copy of the scene synthesiser the traffic is drawn from.

Copied from ``src/repro_torch/data/acoustic.py`` (``_t``, ``synth_uav``,
``_onepole``, ``_chirp``, ``synth_background``, ``add_noise_snr``) and the
window-labelling rule of ``src/repro_torch/launch/monitor.py``'s
``synth_scene``, unchanged, so that the benchmark's inputs stay the same
whatever later changes make to the program's own data modules.
"""
from __future__ import annotations

import numpy as np

SR = 16_000
N_SAMPLES = 12_800  # 0.8 s windows


def _t() -> np.ndarray:
    return np.arange(N_SAMPLES) / SR


def synth_uav(rng: np.random.Generator) -> np.ndarray:
    """One 0.8 s quadrotor window."""
    t = _t()
    n_motors = rng.integers(2, 5)
    base_rps = rng.uniform(45.0, 110.0)  # rotor revs/s
    n_blades = 2
    sig = np.zeros_like(t)
    for _ in range(n_motors):
        rps = base_rps * rng.uniform(0.96, 1.04)  # per-motor detune
        bpf = n_blades * rps
        # RPM wander -> FM jitter
        fm = 1.0 + 0.01 * rng.uniform(0.2, 1.0) * np.cumsum(
            rng.standard_normal(N_SAMPLES)
        ) / np.sqrt(np.arange(1, N_SAMPLES + 1)) / 8.0
        phase = 2 * np.pi * np.cumsum(bpf * fm) / SR
        decay = rng.uniform(0.6, 1.2)
        n_harm = int(min(20, (SR / 2 - 100) / bpf))
        for k in range(1, n_harm + 1):
            amp = k ** (-decay) * rng.uniform(0.7, 1.3)
            sig += amp * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    # AM from load changes
    am = 1.0 + rng.uniform(0.05, 0.3) * np.sin(2 * np.pi * rng.uniform(1, 8) * t)
    sig *= am
    # broadband prop hiss, high-frequency emphasis
    hiss = np.diff(rng.standard_normal(N_SAMPLES + 1))
    sig += rng.uniform(0.05, 0.25) * np.abs(sig).mean() / (np.abs(hiss).mean() + 1e-9) * hiss
    # distance: gain + one-pole lowpass
    lp = _onepole(sig, rng.uniform(0.2, 0.95))
    return (lp / (np.std(lp) + 1e-9)).astype(np.float32)


def _onepole(x: np.ndarray, alpha: float) -> np.ndarray:
    """One-pole lowpass y[n] = (1-a) x[n] + a y[n-1] via truncated-kernel conv.

    A Python sample loop is too slow for 12.8k-sample windows at dataset
    scale; the IIR is equivalent to convolution with (1-a) a^k, truncated
    where the kernel decays below 1e-4.
    """
    k = int(np.ceil(np.log(1e-4) / np.log(max(alpha, 1e-6))))
    k = max(1, min(k, 512))
    kern = (1.0 - alpha) * alpha ** np.arange(k)
    return np.convolve(x, kern)[: len(x)]


def _chirp(t, f0, f1, dur_frac, rng):
    n = len(t)
    start = rng.integers(0, max(1, int(n * (1 - dur_frac))))
    length = int(n * dur_frac)
    seg = np.zeros(n)
    tt = t[:length]
    f = np.linspace(f0, f1, length)
    seg[start : start + length] = np.sin(2 * np.pi * np.cumsum(f) / SR) * np.hanning(length)
    return seg


def synth_background(rng: np.random.Generator) -> np.ndarray:
    """One 0.8 s non-UAV window, drawn from 6 environment classes.

    Classes 2 and 5 are deliberately *confusable*: harmonic machinery whose
    fundamentals overlap the quadrotor BPF band — the airport/urban clutter
    that makes the paper's task sit near 90% rather than at ceiling.
    """
    t = _t()
    kind = rng.integers(0, 6)
    if kind == 0:  # wind: pink-ish noise
        w = rng.standard_normal(N_SAMPLES)
        sig = _onepole(w, 0.97) * 8.0 + 0.1 * w
    elif kind == 1:  # bird chirps: fast FM tones 2-6 kHz
        sig = 0.05 * rng.standard_normal(N_SAMPLES)
        for _ in range(rng.integers(1, 4)):
            f0 = rng.uniform(2000, 5000)
            sig += _chirp(t, f0, f0 * rng.uniform(0.7, 1.4), rng.uniform(0.05, 0.2), rng)
    elif kind == 2:  # distant aircraft: low-frequency harmonic rumble (confusable!)
        f0 = rng.uniform(25.0, 70.0)
        sig = np.zeros_like(t)
        for k in range(1, 12):
            sig += k ** rng.uniform(-1.6, -0.9) * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.28))
        sig += _onepole(rng.standard_normal(N_SAMPLES), 0.995) * 15.0
    elif kind == 3:  # traffic hum
        sig = _onepole(rng.standard_normal(N_SAMPLES), 0.99) * 10.0
        sig += 0.3 * np.sin(2 * np.pi * rng.uniform(80, 120) * t)
    elif kind == 4:  # quiet ambience
        sig = 0.3 * _onepole(rng.standard_normal(N_SAMPLES), 0.9)
    else:  # generator / mower: harmonic stack INSIDE the UAV BPF band, with
        # AM and slight FM wander — the hardest negative
        f0 = rng.uniform(80.0, 200.0)
        fm = 1.0 + 0.005 * np.cumsum(rng.standard_normal(N_SAMPLES)) / np.sqrt(
            np.arange(1, N_SAMPLES + 1)
        )
        phase = 2 * np.pi * np.cumsum(f0 * fm) / SR
        sig = np.zeros_like(t)
        decay = rng.uniform(0.7, 1.3)
        for k in range(1, int(min(18, (SR / 2 - 100) / f0)) + 1):
            sig += k ** (-decay) * np.sin(k * phase + rng.uniform(0, 6.28))
        sig *= 1.0 + rng.uniform(0.05, 0.25) * np.sin(2 * np.pi * rng.uniform(1, 6) * t)
        sig += 0.1 * _onepole(rng.standard_normal(N_SAMPLES), 0.9)
        sig = _onepole(sig, rng.uniform(0.1, 0.8))
    return (sig / (np.std(sig) + 1e-9)).astype(np.float32)


def add_noise_snr(x: np.ndarray, snr_db: float, rng: np.random.Generator) -> np.ndarray:
    """Additive Gaussian noise at a target SNR (paper's augmentation)."""
    p_sig = np.mean(x**2)
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return x + rng.standard_normal(len(x)).astype(np.float32) * np.sqrt(p_noise)


def scene_windows(n_win: int, rng: np.random.Generator) -> tuple[list[np.ndarray], list[int]]:
    """One monitored scene of ``n_win`` windows: background everywhere except
    one UAV pass, each window noised at an SNR in [8, 20] dB (the draw order
    of ``monitor.synth_scene``).  Returns the windows and their labels
    (1 = UAV)."""
    if n_win >= 6:
        on = int(rng.integers(1, n_win - 4))
        off = int(min(n_win - 1, on + rng.integers(3, max(4, n_win // 2))))
    else:
        on, off = 0, n_win  # short scene: all UAV
    wins, labels = [], []
    for i in range(n_win):
        uav = on <= i < off
        x = synth_uav(rng) if uav else synth_background(rng)
        wins.append(add_noise_snr(x, float(rng.uniform(8, 20)), rng))
        labels.append(int(uav))
    return wins, labels
