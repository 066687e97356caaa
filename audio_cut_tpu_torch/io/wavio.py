"""Pure-numpy WAV codec with 24-bit PCM support.

Counterpart of ``audio_cut_tpu/io/wavio.py``. The JAX package encodes PCM
through a small native library (``native/pcm_codec.cpp``); the port keeps to
numpy, rounding the float64 product half to even as the JAX package's numpy
codec does (``native/loader.py``), with the same 1/8388607 and 1/32767 scales.

Supported: PCM 8/16/24/32, IEEE float32/float64, mono or multi-channel,
plus WAVE_FORMAT_EXTENSIBLE headers.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from audio_cut_tpu_torch.exceptions import AudioIOError

_RIFF = b"RIFF"
_WAVE = b"WAVE"
_FMT = b"fmt "
_DATA = b"data"
_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE
_PCM24_SCALE = 8388607.0


@dataclass(frozen=True)
class WavInfo:
    sample_rate: int
    channels: int
    frames: int
    bits_per_sample: int
    format_tag: int

    @property
    def duration(self) -> float:
        return self.frames / float(self.sample_rate) if self.sample_rate else 0.0

    @property
    def subtype(self) -> str:
        if self.format_tag == _FMT_FLOAT:
            return f"FLOAT{self.bits_per_sample}"
        return f"PCM_{self.bits_per_sample}"


def _iter_chunks(buf: memoryview):
    """Yield (chunk_id, offset, size) for every RIFF sub-chunk."""
    pos = 12
    n = len(buf)
    while pos + 8 <= n:
        cid = bytes(buf[pos:pos + 4])
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _parse_header(raw: bytes) -> Tuple[WavInfo, int, int]:
    if len(raw) < 44 or raw[:4] != _RIFF or raw[8:12] != _WAVE:
        raise AudioIOError("not a RIFF/WAVE file")
    buf = memoryview(raw)
    fmt = None
    data_off = data_size = None
    for cid, off, size in _iter_chunks(buf):
        if cid == _FMT and fmt is None:
            if size < 16:
                raise AudioIOError("malformed fmt chunk")
            tag, ch, sr, _brate, _balign, bits = struct.unpack_from("<HHIIHH", buf, off)
            if tag == _FMT_EXTENSIBLE and size >= 40:
                # actual format lives in the first 2 bytes of the GUID subformat
                (tag,) = struct.unpack_from("<H", buf, off + 24)
            fmt = (tag, ch, sr, bits)
        elif cid == _DATA and data_off is None:
            # size comes from the header; callers clamp to the bytes they
            # actually hold (wav_info reads only the head of the file)
            data_off, data_size = off, size
    if fmt is None or data_off is None:
        raise AudioIOError("missing fmt or data chunk")
    tag, ch, sr, bits = fmt
    bytes_per_frame = ch * (bits // 8)
    if bytes_per_frame == 0:
        raise AudioIOError("zero-width samples")
    frames = data_size // bytes_per_frame
    return WavInfo(sr, ch, frames, bits, tag), data_off, data_size


def wav_info(path: Union[str, Path]) -> WavInfo:
    with open(path, "rb") as fh:
        head = fh.read(64 * 1024)
    info, _, _ = _parse_header(head)
    return info


def encode_pcm24(audio: np.ndarray) -> bytes:
    """float32 -> packed little-endian 24-bit PCM (clip, scale, half-even)."""
    flat = np.ascontiguousarray(audio, dtype=np.float32).reshape(-1)
    scaled = np.round(np.clip(flat, -1.0, 1.0).astype(np.float64) * _PCM24_SCALE).astype("<i4")
    as32 = scaled.view(np.uint8).reshape(-1, 4)
    return np.ascontiguousarray(as32[:, :3]).tobytes()


def decode_pcm24(data) -> np.ndarray:
    """Packed little-endian 24-bit PCM -> float32 (scale 1/8388607)."""
    n = len(data) // 3
    b = np.frombuffer(data, dtype=np.uint8, count=n * 3).reshape(-1, 3)
    v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
         | (b[:, 2].astype(np.int32) << 16))
    v = (v ^ 0x800000) - 0x800000
    return (v.astype(np.float64) / _PCM24_SCALE).astype(np.float32)


def encode_pcm16(audio: np.ndarray) -> bytes:
    flat = np.ascontiguousarray(audio, dtype=np.float32).reshape(-1)
    return np.round(np.clip(flat, -1, 1) * 32767.0).astype("<i2").tobytes()


def _decode_pcm(data: np.ndarray, bits: int, tag: int) -> np.ndarray:
    """Decode raw bytes to float32 in [-1, 1)."""
    if tag == _FMT_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        return np.frombuffer(data, dtype="<" + dtype().dtype.char).astype(np.float32)
    if bits == 16:
        return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32767.0
    if bits == 32:
        return (np.frombuffer(data, dtype="<i4").astype(np.float64) / 2147483647.0).astype(np.float32)
    if bits == 8:
        return (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 127.0
    if bits == 24:
        return decode_pcm24(data)
    raise AudioIOError(f"unsupported bit depth: {bits}")


def read_wav(path: Union[str, Path], always_2d: bool = False) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array [T] or [T, C], sample_rate)."""
    raw = Path(path).read_bytes()
    info, off, size = _parse_header(raw)
    size = min(size, len(raw) - off)
    sample_width = max(1, info.bits_per_sample // 8)
    size -= size % (sample_width * info.channels)  # drop a torn trailing frame
    flat = _decode_pcm(np.frombuffer(raw, dtype=np.uint8, count=size, offset=off), info.bits_per_sample, info.format_tag)
    usable = (flat.size // info.channels) * info.channels
    audio = flat[:usable].reshape(-1, info.channels)
    if info.channels == 1 and not always_2d:
        audio = audio[:, 0]
    return np.ascontiguousarray(audio), info.sample_rate


def _encode_pcm(audio: np.ndarray, subtype: str) -> Tuple[bytes, int, int]:
    """Encode float audio -> (payload bytes, format_tag, bits)."""
    if subtype == "PCM_16":
        return encode_pcm16(audio), _FMT_PCM, 16
    if subtype == "PCM_32":
        clipped = np.clip(audio, -1.0, 1.0)
        scaled = np.round(clipped.astype(np.float64) * 2147483647.0).astype("<i4")
        return scaled.tobytes(), _FMT_PCM, 32
    if subtype == "FLOAT":
        return audio.astype("<f4").tobytes(), _FMT_FLOAT, 32
    if subtype == "PCM_24":
        return encode_pcm24(audio), _FMT_PCM, 24
    raise AudioIOError(f"unsupported WAV subtype: {subtype}")


def write_wav_payload(
    path: Union[str, Path],
    payload: bytes,
    sample_rate: int,
    *,
    bits: int = 24,
    channels: int = 1,
) -> None:
    """Write a PRE-ENCODED PCM payload (e.g. device-quantized 24-bit planes,
    ops/pcm.py) without a host float->int pass."""
    _write_riff(path, payload, sample_rate, _FMT_PCM, bits, channels)


def write_wav(
    path: Union[str, Path],
    audio: np.ndarray,
    sample_rate: int,
    subtype: str = "PCM_24",
) -> None:
    """Write float audio ([T] or [T, C]) to a WAV file."""
    arr = np.asarray(audio)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2:
        raise AudioIOError(f"audio must be 1-D or 2-D, got shape {arr.shape}")
    channels = arr.shape[1]
    payload, tag, bits = _encode_pcm(np.ascontiguousarray(arr, dtype=np.float32), subtype)
    _write_riff(path, payload, sample_rate, tag, bits, channels)


def _write_riff(
    path: Union[str, Path],
    payload: bytes,
    sample_rate: int,
    tag: int,
    bits: int,
    channels: int,
) -> None:
    block_align = channels * (bits // 8)
    byte_rate = sample_rate * block_align
    fmt_chunk = struct.pack("<HHIIHH", tag, channels, sample_rate, byte_rate, block_align, bits)
    pad = b"\x00" if len(payload) & 1 else b""
    riff_size = 4 + (8 + len(fmt_chunk)) + (8 + len(payload) + len(pad))
    with open(path, "wb") as fh:
        fh.write(_RIFF + struct.pack("<I", riff_size) + _WAVE)
        fh.write(_FMT + struct.pack("<I", len(fmt_chunk)) + fmt_chunk)
        fh.write(_DATA + struct.pack("<I", len(payload)) + payload + pad)
