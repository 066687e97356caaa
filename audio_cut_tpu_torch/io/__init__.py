from audio_cut_tpu_torch.io.wavio import read_wav, wav_info, write_wav
from audio_cut_tpu_torch.io.audio import load_audio, resample_poly, save_audio, to_mono

__all__ = [
    "read_wav",
    "write_wav",
    "wav_info",
    "load_audio",
    "save_audio",
    "to_mono",
    "resample_poly",
]
