"""The on-device DSP front-end: the PyTorch twin of the numpy front-end.

Counterpart of ``repro/data/features_jax.py``.  With
``accelerator_forward(..., raw_windows=True)`` (and
``MonitorEngine(on_device_features=True)``) the forward starts at the raw
``(B, 12800)`` audio windows, and its first stage is :func:`feature_rows`
on the artifact's device.  The float32 constants (Hann windows, frame
indices, mel filterbank, DCT-II matrix) are built once per kind and device.

Two numerical contracts, as in the reference:

* **numpy vs this front-end is tolerance-bounded, not bitwise.**  The numpy
  path (:func:`repro_torch.data.features.feature_vector`) is the float64
  oracle; this one computes in float32.  ``PARITY_ATOL`` holds the per-kind
  bounds, the reference's own.
* **row i is bitwise independent of its co-batch**, on the CPU and on the
  card: whatever the batch size, the row's slot, the other rows' content or
  silence padding.  Every op is elementwise, a per-row max, or one of the
  fixed-order primitives of :mod:`repro_torch.kernels.frontend` (the mel
  and DCT-II projections and every row sum); each window's FFTs run in a
  call of their own, so an FFT plan never sees the batch count.

The ops follow the reference's ``_feature_batch`` one for one: peak
normalisation, ``reflect`` centre padding, Hann windows, ``re^2 + im^2``,
``log10(. + 1e-10)`` as the reference's ``log`` times ``float32(1/ln 10)``,
the Welch mean over 12 segments, the zcr sign rule, and a mean as the row
sum times ``float32(1/n)``.  ``torch.fft.rfft`` stays a library call: the
reference computes its FFT outside any Pallas kernel.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.f32_math import log_f32
from repro_torch.data.features import (
    FEATURE_DIMS,
    HOP,
    N_FFT,
    N_SAMPLES,
    dct_ii,
    mel_filterbank,
)
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.frontend import inv_f32, project_rows, row_mean

#: per-kind max-abs-deviation bound against the float64 numpy oracle on
#: unit-RMS-normalised feature vectors, the reference's own values.  It
#: covers real audio windows; an all-constant window (exact silence)
#: normalises to 0 in float64 but to an arbitrary finite constant in
#: float32, so only finiteness holds there.
PARITY_ATOL = {
    "mfcc20": 5e-3,
    "mel128": 5e-3,
    "psd": 5e-3,
    "zcr": 1e-4,
}

#: float32(1 / float32(ln 10)): the reference's log10 is log(x) / log(10),
#: which its compiler evaluates as a multiply by this reciprocal
INV_LN10_F32 = float(np.float32(1.0) / np.float32(np.log(10.0)))


# ---------------------------------------------------------------------------
# float32 constants, built once per kind (and once more per device)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def hann32(n: int) -> torch.Tensor:
    return torch.from_numpy(np.hanning(n).astype(np.float32))


@functools.lru_cache(maxsize=8)
def frame_idx(n_samples: int, n_fft: int, hop: int) -> torch.Tensor:
    """Gather indices into the centre-padded signal: (frames, n_fft)."""
    n_frames = 1 + n_samples // hop
    return torch.from_numpy(np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None])


@functools.lru_cache(maxsize=8)
def mel32(n_mels: int) -> torch.Tensor:
    """(bins, n_mels) float32 mel projection (transposed for right-matmul)."""
    return torch.from_numpy(np.ascontiguousarray(mel_filterbank(n_mels).astype(np.float32).T))


@functools.lru_cache(maxsize=8)
def dct32(n_out: int, n_in: int) -> torch.Tensor:
    """(n_in, n_out) float32 DCT-II projection (transposed)."""
    return torch.from_numpy(np.ascontiguousarray(dct_ii(n_out, n_in).astype(np.float32).T))


@functools.lru_cache(maxsize=32)
def _on(device: torch.device, fn, *args) -> torch.Tensor:
    return fn(*args).to(device)


def _c(x: torch.Tensor, fn, *args) -> torch.Tensor:
    """Constant ``fn(*args)`` on ``x``'s device."""
    return _on(x.device, fn, *args)


# ---------------------------------------------------------------------------
# per-row DSP (leading axis = batch)
# ---------------------------------------------------------------------------


def _rfft_power(frames: torch.Tensor) -> torch.Tensor:
    """(B, T, n) -> (B, T, n//2+1) power spectra, ``re^2 + im^2``.  One FFT
    call per window: a plan made for one window's T transforms never sees
    how many windows share the batch."""
    specs = [torch.fft.rfft(f, dim=-1) for f in frames.unbind(0)]
    spec = torch.stack(specs)
    return spec.real * spec.real + spec.imag * spec.imag


def _log10(x: torch.Tensor) -> torch.Tensor:
    return log_f32(x) * INV_LN10_F32


def _project(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(B, T, K) @ (K, M) -> (B, T, M) with a fixed order per output."""
    b, t, k = x.shape
    return project_rows(x.reshape(b * t, k), m).reshape(b, t, m.shape[1])


def _stft_power(x: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP) -> torch.Tensor:
    pad = n_fft // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = xp[:, _c(x, frame_idx, x.shape[1], n_fft, hop)] * _c(x, hann32, n_fft)
    return _rfft_power(frames)


def _melspectrogram(x: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, n) -> (B, frames, n_mels) log-mel energies."""
    return _log10(_project(_stft_power(x), _c(x, mel32, n_mels)) + 1e-10)


def _welch_psd(x: torch.Tensor, n_bins: int = 512) -> torch.Tensor:
    seg = 2 * n_bins
    n_seg = x.shape[1] // seg
    segs = x[:, : n_seg * seg].reshape(-1, n_seg, seg) * _c(x, hann32, seg)
    p = row_mean(_rfft_power(segs).transpose(1, 2))[:, :n_bins]
    return _log10(p + 1e-10)


def _zcr(x: torch.Tensor, n_frames: int = 128) -> torch.Tensor:
    hop = x.shape[1] // n_frames
    frames = x[:, : n_frames * hop].reshape(-1, n_frames, hop)
    signs = torch.sign(frames)
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    crossings = (torch.diff(signs, dim=2).abs() > 0).to(torch.float32)
    # a sum of 0/1 values is exact in any order, so no fixed-order sum needed
    return crossings.sum(dim=2) * inv_f32(crossings.shape[2])


def _std(z: torch.Tensor) -> torch.Tensor:
    """Population standard deviation over the last axis (``jnp.std``)."""
    centered = z - row_mean(z)[:, None]
    return torch.sqrt(row_mean(centered * centered))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """Zero-mean, unit-RMS (paper §IV-A), per row."""
    v = v - row_mean(v)[:, None]
    rms = torch.sqrt(row_mean(v * v))[:, None]
    return v / (rms + 1e-8)


def _feature_batch(x: torch.Tensor, kind: str) -> torch.Tensor:
    bsz = x.shape[0]
    peak = x.abs().amax(dim=1, keepdim=True) + 1e-9
    x = x / peak
    if kind == "mfcc20":
        logmel = _melspectrogram(x, 64)  # (B, 51, 64)
        m = _project(logmel, _c(x, dct32, 20, 64))[:, :51].reshape(bsz, -1)
        pooled = row_mean(logmel.transpose(1, 2))
        p = _welch_psd(x, 512)
        p10 = row_mean(p[:, :510].reshape(bsz, 10, 51))
        z = _zcr(x)
        aux = torch.stack([row_mean(z), _std(z)], dim=1)
        v = torch.cat([m, pooled, p10, aux], dim=1)
    elif kind == "mel128":
        logmel = _melspectrogram(x, 128)[:, :48]
        v = row_mean(logmel.reshape(bsz, 8, 6, 128).transpose(2, 3)).reshape(bsz, -1)
    elif kind == "psd":
        v = _welch_psd(x, 512)
    elif kind == "zcr":
        v = _zcr(x, 128)
    else:
        raise ValueError(f"unknown feature kind {kind!r}")
    return _normalize(v)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def feature_rows(windows: torch.Tensor, kind: str) -> torch.Tensor:
    """(B, n_samples) raw windows -> (B, M) float32 features on the
    windows' device.  Row i's bits do not depend on the batch it came with."""
    if kind not in FEATURE_DIMS:
        raise ValueError(f"unknown feature kind {kind!r}")
    if windows.ndim != 2:
        raise ValueError(f"(B, n_samples) windows expected, got {tuple(windows.shape)}")
    x = windows.to(torch.float32)
    if x.shape[0] == 0:
        return x.new_zeros((0, FEATURE_DIMS[kind]))
    return _feature_batch(x, kind)


def batch_features_torch(windows, kind: str = "mfcc20", *, device="cuda") -> torch.Tensor:
    """Host-callable batched front-end (the twin of
    :func:`repro_torch.data.features.batch_features`): numpy or tensor
    windows in, feature rows on ``device`` out."""
    dev = resolve_device(device)
    if not isinstance(windows, torch.Tensor):
        windows = torch.from_numpy(np.asarray(windows, np.float32))
    return feature_rows(windows.to(dev), kind)


__all__ = ["PARITY_ATOL", "N_SAMPLES", "batch_features_torch", "feature_rows"]
