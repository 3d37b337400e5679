"""Acoustic feature extraction (SHIELD8-UAV §IV-A) in pure numpy.

The port's own copy of ``repro/data/features.py`` (the host front-end of
the serving path); it must stay numerically identical to the reference.

The paper extracts MFCC, pooled mel-spectrogram coefficients, power spectral
density (PSD) and zero-crossing rate (ZCR) with librosa; librosa is not
available offline, so the equivalent DSP is implemented here (STFT → mel
filterbank → DCT-II MFCCs, Welch PSD, framewise ZCR) and unit-tested for the
standard identities (Parseval, DC response, filterbank partition-of-unity).

Every feature set yields a fixed-length 1-D vector (the 1D-F-CNN consumes
``x ∈ R^{1×M}``); lengths are chosen so the canonical deployed model (MFCC-20)
reproduces the paper's flatten size exactly: M=1096 → 3 pools → 137 frames ×
256 ch = 35,072 (Table I).
"""
from __future__ import annotations

import functools

import numpy as np

SR = 16_000
WINDOW_S = 0.8  # paper: 0.8-second windows
N_SAMPLES = int(SR * WINDOW_S)  # 12,800
N_FFT = 1024
HOP = 256

#: feature-set name -> model input length M
FEATURE_DIMS = {
    "mfcc20": 1096,  # 20 MFCC x 51 frames + 64 pooled-mel + 10 log10(PSD) + 2 ZCR
    "mel128": 1024,  # 128 mel bands x 8 pooled time segments
    "psd": 512,  # 512-bin log10 Welch PSD
    "zcr": 128,  # 128-frame ZCR sequence
}


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


def feature_vector(x: np.ndarray, kind: str = "mfcc20") -> np.ndarray:
    """Extract the 1×M feature vector for one 0.8 s window."""
    x = np.asarray(x, np.float64)
    peak = np.max(np.abs(x)) + 1e-9
    x = x / peak  # amplitude normalisation of the raw window
    if kind == "mfcc20":
        m = mfcc(x, 20)[:51].reshape(-1)  # 1020
        pooled = melspectrogram(x, 64).mean(axis=0)  # 64
        p = welch_psd(x, 512)
        p10 = p[:510].reshape(10, 51).mean(axis=1)  # 10 coarse PSD bands
        z = zcr(x)
        aux = np.array([z.mean(), z.std()])  # 2
        v = np.concatenate([m, pooled, p10, aux])
    elif kind == "mel128":
        logmel = melspectrogram(x, 128)[:48]  # (48, 128)
        v = logmel.reshape(8, 6, 128).mean(axis=1).reshape(-1)  # 8 pooled segments
    elif kind == "psd":
        v = welch_psd(x, 512)
    elif kind == "zcr":
        v = zcr(x, 128)
    else:
        raise ValueError(f"unknown feature kind {kind!r}")
    assert v.shape == (FEATURE_DIMS[kind],), (kind, v.shape)
    return _normalize(v).astype(np.float32)


def batch_features(windows: np.ndarray, kind: str = "mfcc20") -> np.ndarray:
    """(N, n_samples) raw windows -> (N, M) feature matrix."""
    return np.stack([feature_vector(w, kind) for w in windows])
