"""Voicing (F0) and formant (LPC) analysis for the legacy multi-feature
pause detector.

Counterpart of ``audio_cut_tpu/ops/voice.py``. The framewise work runs as
torch code on the device of the stem it is given (the vocal stem stays where
the separation left it; a numpy array runs on the CPU):

* F0: one batched YIN pass. Every frame's cumulative-mean-normalised
  difference function comes from its FFT autocorrelation at once. The band
  of lags is copied to the host, where a small Viterbi over coarse log-pitch
  bins smooths the track and a parabolic step refines each frame's lag, in
  numpy, as in the JAX package.
* Formant strength: batched frame autocorrelation, and the order-12 normal
  equations of every frame solved as one batched [N, 12, 12] Toeplitz
  system; the strength is 1 - the normalised LPC residual.
* Formant frequencies of one pause segment: host numpy (Levinson-Durbin and
  the roots of an order-12 polynomial).

Frames are not centred: a signal of n samples gives (n - frame) // hop + 1
frames, with no padding. The LPC window is the symmetric Hann window of
``np.hanning``.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

Audio = Union[np.ndarray, torch.Tensor]


def _as_tensor(audio: Audio) -> torch.Tensor:
    """The stem as a float32 tensor where it lives; a numpy array on the CPU."""
    if isinstance(audio, torch.Tensor):
        return audio.to(torch.float32)
    return torch.from_numpy(np.asarray(audio, dtype=np.float32))


def _frame(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """[N, frame] view of ``x``, N = (len - frame) // hop + 1."""
    return x.unfold(-1, frame, hop)


def _yin_cmnd(x: torch.Tensor, frame: int, hop: int, tau_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cumulative-mean-normalised difference d'(tau) for every frame, [N,
    tau_max] with d'(0) = 1, and each frame's energy [N].

    d(tau) = sum_j (x[j] - x[j+tau])^2 over the frame, for all taus at once
    from the frame autocorrelation (FFT), then normalised by its running mean.
    """
    frames = _frame(x, frame, hop)
    frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    # autocorrelation r(tau) via FFT (power spectrum)
    nfft = 2 * frame
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    ac = torch.fft.irfft(spec * torch.conj(spec), n=nfft, dim=-1)[:, :tau_max]
    # energy terms: e0(tau) = sum_{j<W-tau} x[j]^2, e1(tau) = sum_{j>=tau} x[j]^2
    sq = frames * frames
    csum = torch.cumsum(sq, dim=-1)
    total = csum[:, -1:]
    taus = torch.arange(tau_max, device=x.device)
    e0 = csum[:, frame - 1 - taus]                       # energy of x[0:W-tau]
    e1 = total - torch.where(taus[None, :] > 0, csum[:, torch.clamp(taus - 1, min=0)],
                             torch.zeros((), device=x.device))
    d = torch.clamp(e0 + e1 - 2.0 * ac, min=0.0)         # [N, tau_max]
    # cumulative mean normalisation
    cum = torch.cumsum(d[:, 1:], dim=-1)
    steps = torch.arange(1, tau_max, dtype=torch.float32, device=x.device)
    denom = torch.clamp(cum / steps[None, :], min=1e-12)
    cmnd = torch.cat([torch.ones_like(d[:, :1]), d[:, 1:] / denom], dim=-1)
    return cmnd, total[:, 0]


def yin_geometry(sr: int, frame_s: float = 0.04, hop_s: float = 0.01, fmin: float = 70.0,
                 fmax: float = 500.0) -> Tuple[int, int, int, int]:
    """(frame, hop, tau_min, tau_max) in samples for ``yin_f0``."""
    frame = max(64, int(round(frame_s * sr)))
    hop = max(1, int(round(hop_s * sr)))
    tau_min = max(2, int(sr / fmax))
    tau_max = min(frame - 1, int(sr / fmin) + 1)
    return frame, hop, tau_min, tau_max


def yin_band(x: torch.Tensor, frame: int, hop: int, tau_min: int,
             tau_max: int) -> Tuple[np.ndarray, np.ndarray]:
    """The device part of ``yin_f0`` and its one host copy: the CMND over
    the lags [tau_min, tau_max) [N, L] and the frame energies [N]."""
    with torch.inference_mode():
        cmnd, energy = _yin_cmnd(x, frame, hop, tau_max)
        host = torch.cat([cmnd[:, tau_min:tau_max], energy[:, None]], dim=1).cpu().numpy()
    return host[:, :-1], host[:, -1]


def yin_track(
    band: np.ndarray,
    energy: np.ndarray,
    sr: int,
    frame: int,
    tau_min: int,
    tau_max: int,
    fmin: float = 70.0,
    fmax: float = 500.0,
    n_bins: int = 32,
    switch_cost: float = 4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """The host part of ``yin_f0``: voicing, the Viterbi over log-pitch bins
    and the parabolic refinement, from the copied band and energies."""
    n_frames = band.shape[0]
    if n_frames == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    voicing = np.clip(1.0 - band.min(axis=-1), 0.0, 1.0)
    # silence gate: d(tau)=0 for all-zero frames makes CMND=0 ("perfectly
    # periodic"); a frame with no energy is unvoiced by definition
    rms = np.sqrt(energy / frame)
    voicing = np.where(rms > max(1e-5, 0.01 * float(rms.max() or 0.0)), voicing, 0.0)

    lags = np.arange(tau_min, tau_max)
    # YIN's absolute-threshold rule: a perfectly periodic signal scores ~0 at
    # the true period AND its multiples (subharmonics); prefer the SMALLEST
    # lag that drops below threshold by masking lags far beyond it
    below = band < 0.15
    has_dip = below.any(axis=1)
    first = np.argmax(below, axis=1)
    lag_cap = np.where(has_dip, lags[first] * 1.3, np.inf)
    band = np.where(lags[None, :] > lag_cap[:, None], 4.0, band)

    # coarse log-pitch bins for the Viterbi (pyin's HMM smoothing role)
    freqs = sr / lags                                     # descending
    log_edges = np.linspace(np.log(fmin), np.log(fmax), n_bins + 1)
    bin_of_lag = np.clip(np.searchsorted(log_edges, np.log(freqs)) - 1, 0, n_bins - 1)
    # emission cost per bin = min CMND among that bin's lags
    emit = np.full((n_frames, n_bins), 4.0, np.float32)
    np.minimum.at(emit.T, bin_of_lag, band.T)             # scatter-min over lags
    # transition cost ~ |Δbin| (octave jumps are expensive)
    bins = np.arange(n_bins)
    trans = (np.abs(bins[:, None] - bins[None, :]) / n_bins) * switch_cost
    cost = emit[0].copy()
    back = np.zeros((n_frames, n_bins), np.int32)
    for i in range(1, n_frames):                          # tiny host DP
        step = cost[:, None] + trans
        back[i] = np.argmin(step, axis=0)
        cost = step[back[i], bins] + emit[i]
    path = np.zeros(n_frames, np.int32)
    path[-1] = int(np.argmin(cost))
    for i in range(n_frames - 1, 0, -1):
        path[i - 1] = back[i, path[i]]

    # refine: best lag within the chosen bin per frame, parabolic interpolation
    f0 = np.zeros(n_frames, np.float32)
    for i in range(n_frames):
        sel = np.nonzero(bin_of_lag == path[i])[0]
        if sel.size == 0:
            continue
        j = sel[int(np.argmin(band[i, sel]))]
        tau = float(lags[j])
        if 0 < j < band.shape[1] - 1:
            y0, y1, y2 = band[i, j - 1], band[i, j], band[i, j + 1]
            denom = y0 - 2 * y1 + y2
            if abs(denom) > 1e-12:
                tau += float(np.clip(0.5 * (y0 - y2) / denom, -1.0, 1.0))
        f0[i] = sr / tau
    return f0, voicing.astype(np.float32)


def yin_f0(
    audio: Audio,
    sr: int,
    frame_s: float = 0.04,
    hop_s: float = 0.01,
    fmin: float = 70.0,
    fmax: float = 500.0,
    n_bins: int = 32,
    switch_cost: float = 4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame (f0_hz, voicing) with Viterbi pitch-track smoothing, on the
    host. ``audio`` is a tensor on its device or a numpy array (CPU).

    voicing in [0, 1] = 1 - min CMND (strength of the best periodic
    explanation). f0 is 0 where the frame grid has no usable lag range.
    """
    frame, hop, tau_min, tau_max = yin_geometry(sr, frame_s, hop_s, fmin, fmax)
    x = _as_tensor(audio)
    if tau_max <= tau_min + 2 or x.shape[-1] < frame:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    band, energy = yin_band(x, frame, hop, tau_min, tau_max)
    return yin_track(band, energy, sr, frame, tau_min, tau_max, fmin, fmax, n_bins, switch_cost)


def _lpc_residual(x: torch.Tensor, frame: int, hop: int, order: int) -> torch.Tensor:
    """Normalised LPC residual energy per frame, [N] in [0, 1].

    All-pole fit by the autocorrelation method, solved as ONE batched
    Toeplitz system (normal equations R a = r, [N, order, order]) instead of
    a sequential Levinson recursion. Low residual = strong resonant
    (formant) structure; white noise stays near 1.
    """
    frames = _frame(x, frame, hop)
    frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    win = torch.hann_window(frame, periodic=False, dtype=torch.float32, device=x.device)
    frames = frames * win[None, :]
    nfft = 2 * frame
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    r = torch.fft.irfft(spec * torch.conj(spec), n=nfft, dim=-1)[:, : order + 1]  # [N, order+1]
    r0 = torch.clamp(r[:, 0], min=1e-12)
    rn = r / r0[:, None]                                  # normalise for conditioning
    i = torch.arange(order, device=x.device)
    toe = rn[:, torch.abs(i[:, None] - i[None, :])]       # [N, order, order]
    eye = torch.eye(order, dtype=torch.float32, device=x.device)
    toe = toe + 1e-4 * eye[None]                          # silent-frame regulariser
    a = torch.linalg.solve(toe, rn[:, 1: order + 1, None])[..., 0]  # [N, order]
    err = 1.0 - torch.sum(a * rn[:, 1: order + 1], dim=-1)
    return torch.clamp(err, 0.0, 1.0)


def lpc_geometry(sr: int, frame_s: float = 0.04, hop_s: float = 0.01,
                 order: int = 12) -> Tuple[int, int]:
    """(frame, hop) in samples for ``lpc_formant_strength``."""
    return max(order * 4, int(round(frame_s * sr))), max(1, int(round(hop_s * sr)))


def lpc_formant_strength(
    audio: Audio,
    sr: int,
    frame_s: float = 0.04,
    hop_s: float = 0.01,
    order: int = 12,
) -> np.ndarray:
    """Per-frame formant strength in [0, 1] (1 = strongly resonant/voiced), on
    the host. ``audio`` is a tensor on its device or a numpy array (CPU).

    Defined as 1 - normalised LPC residual energy: a vocal tract's all-pole
    resonances leave little residual; silence/noise leaves most of the energy.
    """
    frame, hop = lpc_geometry(sr, frame_s, hop_s, order)
    x = _as_tensor(audio)
    if x.shape[-1] < frame:
        return np.zeros(0, np.float32)
    with torch.inference_mode():
        res = _lpc_residual(x, frame, hop, order).cpu().numpy()
    return np.clip(1.0 - res, 0.0, 1.0).astype(np.float32)


def lpc_formant_frequencies(
    segment: np.ndarray, sr: int, order: int = 12
) -> np.ndarray:
    """Formant frequencies (Hz) of one segment from LPC polynomial roots, on
    the host (it runs per pause segment, not per frame). Returns sorted
    resonance frequencies with bandwidth < 700 Hz in the 150-5500 Hz band.
    """
    seg = np.asarray(segment, np.float64)
    seg = seg - seg.mean()
    if seg.size < order * 4 or not np.any(seg):
        return np.zeros(0, np.float64)
    # autocorrelation method on the host for one segment
    n = min(seg.size, 8192)
    s = seg[:n] * np.hanning(n)
    spec = np.fft.rfft(s, n=2 * n)
    r = np.fft.irfft(spec * np.conj(spec))[: order + 1]
    if r[0] <= 0:
        return np.zeros(0, np.float64)
    # Levinson-Durbin (host, tiny): a[i] such that x[n] ~ sum_i a[i] x[n-i]
    a = np.zeros(order + 1)
    err = r[0]
    for m in range(1, order + 1):
        acc = r[m] - np.dot(a[1:m], r[m - 1:0:-1])
        k = acc / err if err > 1e-12 else 0.0
        a_new = a.copy()
        a_new[m] = k
        a_new[1:m] = a[1:m] - k * a[m - 1:0:-1]
        a = a_new
        err *= (1.0 - k * k)
    poly = np.concatenate([[1.0], -a[1:]])
    roots = np.roots(poly)
    roots = roots[np.imag(roots) > 0]
    if roots.size == 0:
        return np.zeros(0, np.float64)
    freqs = np.angle(roots) * sr / (2 * np.pi)
    bw = -0.5 * sr / np.pi * np.log(np.clip(np.abs(roots), 1e-9, None))
    keep = (freqs > 150.0) & (freqs < 5500.0) & (bw < 700.0)
    return np.sort(freqs[keep])
