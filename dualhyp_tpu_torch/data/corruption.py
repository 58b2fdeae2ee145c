"""Audio corruption: host-side numpy, deterministic replay.

The audio part of `dualhyp_tpu/data/corruption.py`, copied:

  * `add_audio_noise`: SNR-controlled additive noise over a recorded span
    (tile noise to length, RMS-match to the target SNR, add over
    [start_fr, start_fr+occ_len]) - ref: data/av_dataset.py:171-187
  * `sample_audio_corruption`: random SNR + beta(2,2)-length chunk placement
    used when GENERATING corruption configs - ref: data/make_json_asr.py:212-242
  * `load_wav`: mono float32 at 16 kHz (scipy)

The video transforms and the visual occluders are not ported yet (slice 7).
"""

from __future__ import annotations

import math

import numpy as np


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def add_audio_noise(audio: np.ndarray, noise: np.ndarray, cfg: dict) -> np.ndarray:
    """cfg: {snr, start_fr, occ_len} (ref: av_dataset.py:171-187)."""
    audio = np.asarray(audio, np.float32).copy()
    noise = np.asarray(noise, np.float32)
    audio_rms = np.sqrt(np.mean(np.square(audio)))
    if len(audio) >= len(noise):
        reps = int(np.ceil(len(audio) / len(noise)))
        noise = np.concatenate([noise] * reps)
    noise = noise[: len(audio)]
    noise_rms = np.sqrt(np.mean(np.square(noise)))
    target_rms = audio_rms / (10 ** (int(cfg["snr"]) / 20))
    adjusted = noise * (target_rms / max(noise_rms, 1e-12))
    start, occ = cfg["start_fr"], cfg["occ_len"]
    audio[start : start + occ] += adjusted[start : start + occ]
    return audio


def sample_audio_corruption(total_len: int, rng: np.random.Generator,
                            snr_choices=(-5, 0, 5), whole_utterance_p=0.5) -> dict:
    """Random corruption config in the offline-generator style
    (beta(2,2) chunk length, ref: make_json_asr.py:212-242)."""
    snr = int(rng.choice(snr_choices))
    if rng.random() < whole_utterance_p:
        start, occ = 0, total_len
    else:
        occ = int(np.clip(rng.beta(2, 2), 0.05, 1.0) * total_len)
        start = int(rng.integers(0, max(total_len - occ, 1)))
    return {"total_len": total_len, "start_fr": start, "occ_len": occ, "snr": snr}


def load_wav(path, target_sr: int = 16000) -> np.ndarray:
    """Mono float32 waveform at 16 kHz. scipy-based (the reference shells
    out to ffmpeg, ref: whisper/audio.py:25-62); resamples via polyphase."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if sr != target_sr:
        from scipy.signal import resample_poly

        g = math.gcd(sr, target_sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return data
