"""Frozen copy of the host mfcc20 front-end that makes the archived rows.

Copied from ``src/repro_torch/data/features.py`` (the numpy DSP: STFT, mel
filterbank, DCT-II MFCCs, Welch PSD, ZCR, and ``feature_vector``'s mfcc20
branch), unchanged but for the other feature kinds, which no traffic mix
uses.  The benchmark's rows come from here, so a change to the program's
front-end never changes the inputs it is measured on.
"""
from __future__ import annotations

import functools

import numpy as np

SR = 16_000
N_FFT = 1024
HOP = 256
#: length of the mfcc20 vector: 20 MFCC x 51 frames + 64 pooled mel + 10 PSD bands + 2 ZCR
MFCC20_DIM = 1096


def frame_signal(x: np.ndarray, n_fft: int = N_FFT, hop: int = HOP) -> np.ndarray:
    """Centre-padded frames, librosa-compatible count: 1 + len//hop."""
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + len(x) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return xp[idx]


@functools.lru_cache(maxsize=8)
def _hann(n: int) -> np.ndarray:
    """Cached Hann window (np.hanning rebuilds a cosine table per call)."""
    return np.hanning(n)


def stft_power(x: np.ndarray, n_fft: int = N_FFT, hop: int = HOP) -> np.ndarray:
    """Power spectrogram, shape (frames, n_fft//2+1)."""
    frames = frame_signal(x, n_fft, hop) * _hann(n_fft)[None, :]
    spec = np.fft.rfft(frames, axis=-1)
    return np.abs(spec) ** 2


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int, n_fft: int = N_FFT, sr: int = SR, fmin: float = 20.0, fmax: float = 7600.0) -> np.ndarray:
    """Triangular mel filterbank (Slaney-style, area-normalised), (n_mels, bins)."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(bins)))
    for i in range(n_mels):
        lo, ctr, hi = pts[i], pts[i + 1], pts[i + 2]
        up = (bins - lo) / max(ctr - lo, 1e-9)
        down = (hi - bins) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        norm = fb[i].sum()
        if norm > 0:
            fb[i] /= norm
    return fb


def melspectrogram(x: np.ndarray, n_mels: int) -> np.ndarray:
    """(frames, n_mels) log-mel energies."""
    p = stft_power(x)
    mel = p @ mel_filterbank(n_mels).T
    return np.log10(mel + 1e-10)


@functools.lru_cache(maxsize=8)
def dct_ii(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in); cached like mel_filterbank
    (rebuilt per *window* otherwise — the oracle path shouldn't be
    gratuitously slow)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    m[0] *= 1.0 / np.sqrt(2)
    return m * np.sqrt(2.0 / n_in)


def mfcc(x: np.ndarray, n_mfcc: int = 20, n_mels: int = 64) -> np.ndarray:
    """(frames, n_mfcc) MFCCs."""
    logmel = melspectrogram(x, n_mels)
    return logmel @ dct_ii(n_mfcc, n_mels).T


def welch_psd(x: np.ndarray, n_bins: int = 512) -> np.ndarray:
    """Welch-averaged log10 PSD, length n_bins."""
    seg = 2 * n_bins
    n_seg = len(x) // seg
    segs = x[: n_seg * seg].reshape(n_seg, seg) * _hann(seg)[None, :]
    p = np.mean(np.abs(np.fft.rfft(segs, axis=-1)) ** 2, axis=0)[:n_bins]
    return np.log10(p + 1e-10)


def zcr(x: np.ndarray, n_frames: int = 128) -> np.ndarray:
    """Per-frame zero-crossing rate, length n_frames."""
    hop = len(x) // n_frames
    frames = x[: n_frames * hop].reshape(n_frames, hop)
    signs = np.sign(frames)
    signs[signs == 0] = 1
    return np.mean(np.abs(np.diff(signs, axis=1)) > 0, axis=1)


def _normalize(v: np.ndarray) -> np.ndarray:
    """Amplitude normalisation (paper §IV-A): zero-mean, unit-RMS."""
    v = v - np.mean(v)
    rms = np.sqrt(np.mean(v**2))
    return v / (rms + 1e-8)


def feature_vector(x: np.ndarray) -> np.ndarray:
    """The mfcc20 1x1096 feature vector of one 0.8 s window."""
    x = np.asarray(x, np.float64)
    peak = np.max(np.abs(x)) + 1e-9
    x = x / peak  # amplitude normalisation of the raw window
    m = mfcc(x, 20)[:51].reshape(-1)  # 1020
    pooled = melspectrogram(x, 64).mean(axis=0)  # 64
    p = welch_psd(x, 512)
    p10 = p[:510].reshape(10, 51).mean(axis=1)  # 10 coarse PSD bands
    z = zcr(x)
    aux = np.array([z.mean(), z.std()])  # 2
    v = np.concatenate([m, pooled, p10, aux])
    if v.shape != (MFCC20_DIM,):
        raise AssertionError(v.shape)
    return _normalize(v).astype(np.float32)


def batch_features(windows: np.ndarray) -> np.ndarray:
    """(N, 12800) raw windows -> (N, 1096) mfcc20 feature rows."""
    return np.stack([feature_vector(w) for w in windows])
