"""Synthetic stem generator for training the ConvTDF separator.

A copy of ``audio_cut_tpu/training/sep_data.py`` in plain numpy: for a given
``np.random.Generator`` state it gives the same pairs and batches, bit for
bit. It generates (mix, vocal) pairs at 44.1 kHz whose stems carry the cues
a mask net must learn to discriminate:

* vocal stem: phrase-structured harmonic "voice" with vibrato f0 contours,
  rolloff harmonics with formant-like spectral shaping, syllabic amplitude
  modulation and breathy consonant noise at phrase onsets;
* instrumental stem: chord stacks (static pitch, no vibrato or AM),
  basslines, percussion on a beat grid and broadband pads, including
  sections louder than the vocal so the net cannot learn an energy shortcut.

Batches are (mix [B, S], vocal [B, S]) float32, as the trainer's WAV pairs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SR = 44100

# rough formant centers (Hz) for a few vowel colors; harmonics near a formant
# get boosted, giving the voice its spectral-envelope signature
_FORMANTS = [
    (800, 1150),   # /a/
    (400, 2000),   # /e/
    (250, 2300),   # /i/
    (450, 800),    # /o/
    (350, 600),    # /u/
]


def _formant_gain(freqs: np.ndarray, f1: float, f2: float) -> np.ndarray:
    g = np.ones_like(freqs)
    for fc, bw, amp in ((f1, 120.0, 2.5), (f2, 180.0, 1.8)):
        g += amp * np.exp(-0.5 * ((freqs - fc) / bw) ** 2)
    return g


def _vocal_phrase(rng: np.random.Generator, n: int) -> np.ndarray:
    """One sung phrase: gliding vibrato f0, formant-shaped harmonics, syllabic AM."""
    t = np.arange(n) / SR
    f0_start = rng.uniform(110, 420)
    f0_end = f0_start * rng.uniform(0.85, 1.2)
    vib_rate = rng.uniform(4.5, 6.8)
    vib_depth = rng.uniform(0.01, 0.03)
    f0 = np.linspace(f0_start, f0_end, n) * (
        1 + vib_depth * np.sin(2 * np.pi * vib_rate * t + rng.uniform(0, 6.28))
    )
    phase = 2 * np.pi * np.cumsum(f0) / SR
    f1, f2 = _FORMANTS[rng.integers(len(_FORMANTS))]
    x = np.zeros(n)
    for h in range(1, 11):
        fh = h * np.median(f0)
        if fh > SR / 2 - 2000:
            break
        gain = _formant_gain(np.array([fh]), f1, f2)[0] / (h ** 1.1)
        x += gain * np.sin(h * phase + rng.uniform(0, 6.28))
    # syllabic AM 2.5-6 Hz, clipped-positive so syllables have true gaps
    am = 0.3 + 0.7 * np.clip(
        np.sin(2 * np.pi * rng.uniform(2.5, 6.0) * t + rng.uniform(0, 6.28)), 0.0, None
    )
    # breathy consonant at onset
    breath_n = int(rng.uniform(0.02, 0.06) * SR)
    if breath_n < n:
        breath = rng.standard_normal(breath_n) * np.exp(-np.arange(breath_n) / (0.01 * SR))
        x[:breath_n] += 0.6 * breath
    edge = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (0.02 * SR))
    return (x * am * edge).astype(np.float32)


def vocal_stem(rng: np.random.Generator, n: int) -> np.ndarray:
    """Phrase/rest structured vocal track."""
    out = np.zeros(n, np.float32)
    pos = int(rng.uniform(0, 0.4) * SR)
    while pos < n - int(0.25 * SR):
        phrase_n = int(rng.uniform(0.4, 2.2) * SR)
        phrase_n = min(phrase_n, n - pos)
        out[pos:pos + phrase_n] += rng.uniform(0.25, 0.6) * _vocal_phrase(rng, phrase_n)
        pos += phrase_n + int(rng.uniform(0.15, 1.2) * SR)
    return out


def instrumental_stem(rng: np.random.Generator, n: int) -> np.ndarray:
    """Chords + bass + percussion + pad; can be louder than the vocal."""
    t = np.arange(n) / SR
    out = np.zeros(n, np.float32)
    # chord stack: static pitches, slow envelope, no vibrato/AM
    root = rng.uniform(65, 330)
    chord_env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.05, 0.25) * t)
    for ratio in (1.0, 1.25, 1.5, 2.0):
        out += (rng.uniform(0.06, 0.22) * chord_env
                * np.sin(2 * np.pi * root * ratio * t + rng.uniform(0, 6.28))).astype(np.float32)
    # bassline: octave below root, gated on half-beats
    period = rng.uniform(0.3, 0.6)
    gate = ((t % period) < period * 0.6).astype(np.float32)
    out += (rng.uniform(0.1, 0.3) * gate * np.sin(2 * np.pi * root / 2 * t)).astype(np.float32)
    # percussion: exponential-decay noise hits on the beat grid
    for beat in np.arange(rng.uniform(0, period), t[-1], period):
        i = int(beat * SR)
        env_n = min(int(rng.uniform(0.02, 0.05) * SR), n - i)
        if env_n <= 0:
            continue
        env = np.exp(-np.arange(env_n) / rng.uniform(100, 500))
        out[i:i + env_n] += (rng.uniform(0.15, 0.5) * env
                             * rng.standard_normal(env_n)).astype(np.float32)
    # broadband pad
    out += (rng.standard_normal(n) * rng.uniform(0.005, 0.05)).astype(np.float32)
    return out


def synth_pair(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """One (mix, vocal) pair, peak-normalized together (same scale on both)."""
    vocal = vocal_stem(rng, n)
    inst = instrumental_stem(rng, n) * rng.uniform(0.5, 1.6)
    mix = vocal + inst
    peak = max(float(np.abs(mix).max()), 1e-6)
    if peak > 1.0:
        mix = mix / peak
        vocal = vocal / peak
    return mix.astype(np.float32), vocal.astype(np.float32)


def _channel_reverb(rng: np.random.Generator, x: np.ndarray) -> np.ndarray:
    """Exponential-decay noise reverb (FFT convolution), unit-peak-preserving."""
    ir_n = int(rng.uniform(0.1, 0.4) * SR)
    ir = rng.standard_normal(ir_n) * np.exp(-np.arange(ir_n) / (rng.uniform(0.04, 0.1) * SR))
    ir[0] = 1.0
    n = x.size
    m = 1 << int(np.ceil(np.log2(n + ir_n)))
    y = np.fft.irfft(np.fft.rfft(x, m) * np.fft.rfft(ir, m), m)[:n]
    y = y / max(1e-9, float(np.abs(y).max())) * float(np.abs(x).max())
    wet = rng.uniform(0.08, 0.35)
    return ((1 - wet) * x + wet * y).astype(np.float32)


def augment_pair(
    rng: np.random.Generator, mix: np.ndarray, vocal: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Channel-effect augmentation for training pairs: per-stem reverb, bus
    saturation (half the nonlinearity attributed to the vocal target, the
    realistic mastering convention), noise floor. Raises robustness to the
    production conditions the dry generator never produces."""
    inst = mix - vocal
    if rng.random() < 0.7:
        vocal = _channel_reverb(rng, vocal)
        inst = _channel_reverb(rng, inst)
    mix = vocal + inst
    if rng.random() < 0.5:
        drive = rng.uniform(1.0, 2.5)
        sat = np.tanh(mix * drive) / drive
        vocal = vocal + (sat - mix) * 0.5
        mix = sat
    if rng.random() < 0.5:
        mix = mix + (rng.standard_normal(mix.size) * rng.uniform(0.001, 0.006)).astype(np.float32)
    peak = max(float(np.abs(mix).max()), 1e-6)
    if peak > 1.0:
        mix, vocal = mix / peak, vocal / peak
    return mix.astype(np.float32), vocal.astype(np.float32)


def synth_batches(window: int, batch: int, rng: np.random.Generator,
                  augment: bool = False):
    """Infinite iterator of (mix [B, S], vocal [B, S]) training batches."""
    while True:
        mixes = np.empty((batch, window), np.float32)
        vocals = np.empty((batch, window), np.float32)
        for b in range(batch):
            mixes[b], vocals[b] = synth_pair(rng, window)
            if augment:
                mixes[b], vocals[b] = augment_pair(rng, mixes[b], vocals[b])
        yield mixes, vocals


def si_snr(est: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SNR in dB (higher is better separation)."""
    ref = ref - ref.mean()
    est = est - est.mean()
    proj = (np.dot(est, ref) / (np.dot(ref, ref) + eps)) * ref
    noise = est - proj
    return float(10.0 * np.log10((np.dot(proj, proj) + eps) / (np.dot(noise, noise) + eps)))
