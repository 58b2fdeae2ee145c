"""Audio/visual corruption: host-side numpy, deterministic replay.

A copy of `dualhyp_tpu/data/corruption.py`:

  * `add_audio_noise`: SNR-controlled additive noise over a recorded span
    (tile noise to length, RMS-match to the target SNR, add over
    [start_fr, start_fr+occ_len]) - ref: data/av_dataset.py:171-187
  * `sample_audio_corruption`: random SNR + beta(2,2)-length chunk placement
    used when GENERATING corruption configs - ref: data/make_json_asr.py:212-242
  * `load_wav`: mono float32 at 16 kHz (scipy)
  * visual occlusion replay with deterministic `occlude_config`
    (pixelate / blur implemented in pure numpy; patch-overlay types (coco,
    hands) require the occluder asset packs and are loaded lazily) -
    ref: data/visual_corruption.py:180-236, 289+
  * video preprocessing pipelines: train = Normalize(0,255) -> RandomCrop
    (88x88) -> Normalize(mean .421, std .165); val/test = CenterCrop -
    ref: data/utils.py:196-212
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def normalize(frames: np.ndarray, mean: float, std: float) -> np.ndarray:
    return (frames.astype(np.float32) - mean) / std


def center_crop(frames: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    t, h, w = frames.shape[:3]
    ch, cw = size
    dh, dw = (h - ch) // 2, (w - cw) // 2
    return frames[:, dh : dh + ch, dw : dw + cw]


def random_crop(frames: np.ndarray, size: Tuple[int, int],
                rng: np.random.Generator) -> np.ndarray:
    t, h, w = frames.shape[:3]
    ch, cw = size
    dh = int(rng.integers(0, h - ch + 1))
    dw = int(rng.integers(0, w - cw + 1))
    return frames[:, dh : dh + ch, dw : dw + cw]


def horizontal_flip(frames: np.ndarray, flip: bool) -> np.ndarray:
    return frames[:, :, ::-1] if flip else frames


def train_pipeline(frames: np.ndarray, rng: np.random.Generator,
                   crop=(88, 88)) -> np.ndarray:
    x = normalize(frames, 0.0, 255.0)
    x = random_crop(x, crop, rng)
    x = horizontal_flip(x, bool(rng.random() < 0.5))
    return normalize(x, 0.421, 0.165)


def eval_pipeline(frames: np.ndarray, crop=(88, 88)) -> np.ndarray:
    x = normalize(frames, 0.0, 255.0)
    x = center_crop(x, crop)
    return normalize(x, 0.421, 0.165)


def get_preprocessing_pipelines():
    return {
        "train": lambda f, rng=np.random.default_rng(0): train_pipeline(f, rng),
        "val": eval_pipeline,
        "test": eval_pipeline,
    }


# ---------------------------------------------------------------------------
# visual occlusion (ref: data/visual_corruption.py)
# ---------------------------------------------------------------------------

def image_pixelate(image: np.ndarray, block: int = 5) -> np.ndarray:
    """Whole-frame pixelation (ref: visual_corruption.py:289-300,
    pixelate_snr=5)."""
    h, w = image.shape[:2]
    small_h, small_w = max(h // block, 1), max(w // block, 1)
    ys = (np.arange(h) * small_h // h).clip(0, small_h - 1)
    xs = (np.arange(w) * small_w // w).clip(0, small_w - 1)
    small = image[:: max(h // small_h, 1), :: max(w // small_w, 1)][:small_h, :small_w]
    return small[ys][:, xs]


def _gaussian_kernel1d(k: int, sigma: float) -> np.ndarray:
    x = np.arange(k, dtype=np.float64) - (k - 1) / 2
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def image_blur(image: np.ndarray, k: int = 9, sigma: float = 6.0) -> np.ndarray:
    """Separable gaussian blur (ref: GaussianBlur(kernel_size=(9,9),
    sigma=6.0), visual_corruption.py:53-55, 208-213)."""
    kern = _gaussian_kernel1d(k, sigma)
    pad = k // 2
    x = image.astype(np.float32)
    for axis in (0, 1):
        padded = np.pad(
            x, [(pad, pad) if a == axis else (0, 0) for a in range(x.ndim)],
            mode="reflect",
        )
        x = np.apply_along_axis(
            lambda v: np.convolve(v, kern, mode="valid"), axis, padded
        )
    return x.astype(image.dtype)


def occlusion_span(total_len: int, rng: np.random.Generator,
                   fixlen: float = 0.0) -> Tuple[int, int]:
    """beta(2,2)-length chunk like the reference occluder
    (ref: visual_corruption.py:195-201)."""
    if fixlen:
        occ = int(total_len * fixlen)
    else:
        occ = int(np.clip(rng.beta(2, 2), 0.05, 1.0) * total_len)
    start = int(rng.integers(0, max(total_len - occ, 1)))
    return start, occ


# -- procedural occluder patches --------------------------------------------
#
# The reference overlays object crops from coco_object.7z / 11k-hands at lip
# landmarks (ref: visual_corruption.py:9-103, 238-288). Those asset packs are
# external downloads; when absent we synthesise deterministic patches with
# the same geometry (named, alpha-masked, resizable), so recorded
# `occlude_config`s replay with identical mask geometry and substitutable
# appearance. A real asset directory (image/ + mask/ subdirs) is used when
# supplied.

_N_PROC_OCCLUDERS = 12


def _box_smooth(x: np.ndarray, k: int, iters: int = 3) -> np.ndarray:
    for _ in range(iters):
        c = np.cumsum(np.pad(x, ((k, k), (0, 0)), mode="edge"), axis=0)
        x = (c[2 * k :] - c[: -2 * k]) / (2 * k)
        c = np.cumsum(np.pad(x, ((0, 0), (k, k)), mode="edge"), axis=1)
        x = (c[:, 2 * k :] - c[:, : -2 * k]) / (2 * k)
    return x


def procedural_occluder(name: str, occ_type: str = "coco",
                        size: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic (RGB uint8 image, uint8 0/255 alpha mask)
    derived from the occluder name, substituting for the coco/hands packs."""
    import zlib

    seed = zlib.crc32(f"{occ_type}/{name}".encode())
    prng = np.random.default_rng(seed)
    s = size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)

    if occ_type == "hands":
        # palm ellipse + four finger bars, hand-like silhouette
        cy, cx = 0.62 * s, 0.5 * s
        mask = ((yy - cy) / (0.34 * s)) ** 2 + ((xx - cx) / (0.30 * s)) ** 2 < 1
        for f in range(4):
            fx = (0.30 + 0.14 * f) * s
            width = 0.05 * s
            top = (0.08 + 0.04 * abs(f - 1.5)) * s
            mask |= (np.abs(xx - fx) < width) & (yy > top) & (yy < cy)
        base = np.array([198, 160, 132], np.float32)  # skin-ish
    else:
        # smooth random blob (object patch stand-in)
        noise = prng.normal(size=(s, s)).astype(np.float32)
        smooth = _box_smooth(noise, k=s // 8)
        mask = smooth > np.quantile(smooth, 0.55)
        base = prng.uniform(40, 220, size=3).astype(np.float32)

    texture = _box_smooth(prng.normal(size=(s, s)).astype(np.float32), k=4)
    texture = 30.0 * texture / (np.abs(texture).max() + 1e-6)
    img = np.clip(base[None, None] + texture[..., None], 0, 255)
    img = (img * mask[..., None]).astype(np.uint8)
    return img, (mask.astype(np.uint8) * 255)


def _resize_nearest(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(out_h) * h // out_h).clip(0, h - 1)
    xs = (np.arange(out_w) * w // out_w).clip(0, w - 1)
    return img[ys][:, xs]


class OccluderBank:
    """Named occluder patches: a real asset pack directory when available
    (ref: visual_corruption.py:14-48), else procedural patches."""

    def __init__(self, occ_type: str, patch_dir=None):
        self.occ_type = occ_type
        self.patch_dir = None
        self.names = [f"proc_{occ_type}_{i}.jpeg" for i in range(_N_PROC_OCCLUDERS)]
        if patch_dir is not None:
            from pathlib import Path

            d = Path(patch_dir)
            img_dir = d / ("11k-hands_sr" if occ_type == "hands" else "object_image_sr")
            if img_dir.is_dir():
                self.patch_dir = d
                self.names = sorted(p.name for p in img_dir.iterdir())

    def get(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        if self.patch_dir is None or name.startswith("proc_"):
            return procedural_occluder(name, self.occ_type)
        import cv2

        img_dir = "11k-hands_sr" if self.occ_type == "hands" else "object_image_sr"
        mask_dir = "11k-hands_masks" if self.occ_type == "hands" else "object_mask_x4"
        mask_name = name.rsplit(".", 1)[0] + ".png"
        img = cv2.cvtColor(
            cv2.imread(str(self.patch_dir / img_dir / name), -1), cv2.COLOR_BGR2RGB
        )
        mask = cv2.cvtColor(
            cv2.imread(str(self.patch_dir / mask_dir / mask_name)),
            cv2.COLOR_BGR2GRAY,
        )
        mask = _resize_nearest(mask, img.shape[0], img.shape[1])
        return (img * (mask[..., None] > 0)).astype(np.uint8), mask


def overlay_image_alpha(img: np.ndarray, overlay: np.ndarray, y: int, x: int,
                        alpha: np.ndarray) -> np.ndarray:
    """Alpha-composite `overlay` onto `img` at (y, x)
    (ref: visual_corruption.py:238-262). img: (H, W, 3) float; alpha in
    [0, 1] with overlay's H x W."""
    y1, y2 = max(0, y), min(img.shape[0], y + overlay.shape[0])
    x1, x2 = max(0, x), min(img.shape[1], x + overlay.shape[1])
    y1o, y2o = max(0, -y), min(overlay.shape[0], img.shape[0] - y)
    x1o, x2o = max(0, -x), min(overlay.shape[1], img.shape[1] - x)
    if y1 >= y2 or x1 >= x2 or y1o >= y2o or x1o >= x2o:
        return img
    a = alpha[y1o:y2o, x1o:x2o]
    img[y1:y2, x1:x2] = (
        a * overlay[y1o:y2o, x1o:x2o] + (1.0 - a) * img[y1:y2, x1:x2]
    )
    return img


def overlay_image_hands(img: np.ndarray, overlay: np.ndarray,
                        alpha: np.ndarray) -> np.ndarray:
    """Hands overlay pinned below center (ref: visual_corruption.py:264-288
    — position is a fixed hotfix in the reference)."""
    y1, y2, x1, x2 = 20, 96, 0, 96
    y1o, y2o, x1o, x2o = 0, 76, 0, 96
    h = min(y2, img.shape[0]) - y1
    w = min(x2, img.shape[1]) - x1
    if h <= 0 or w <= 0:
        return img
    a = alpha[y1o : y1o + h, x1o : x1o + w]
    img[y1 : y1 + h, x1 : x1 + w] = (
        a * overlay[y1o : y1o + h, x1o : x1o + w]
        + (1.0 - a) * img[y1 : y1 + h, x1 : x1 + w]
    )
    return img


_RGB2GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)


def _occluder_for_config(occ_type: str, bank: OccluderBank, cfg: dict,
                         rng: Optional[np.random.Generator]):
    """Patch + mask resized per config (ref: visual_corruption.py:58-103).
    Appearance jitter (the reference's albumentations augmentor) applies
    only when an rng is given — the reference does not record augmentor
    state, so replay is geometry-exact, not pixel-exact, there too."""
    img, mask = bank.get(cfg["occlude_img"])
    if rng is not None:
        # brightness/contrast jitter (ref augmentor RandomBrightnessContrast)
        scale = 1.0 + rng.uniform(-0.1, 0.1)
        shift = rng.uniform(-12, 12)
        img = np.clip(img.astype(np.float32) * scale + shift, 0, 255)
    size = int(cfg["occluder_size"])
    img = _resize_nearest(np.asarray(img, np.float32), size, size)
    mask = _resize_nearest(mask, size, size)
    if occ_type == "hands":
        img = img[::-1, ::-1]  # ROTATE_180 (ref: visual_corruption.py:92-95)
        mask = mask[::-1, ::-1]
    return img, mask.astype(np.float32)[..., None].repeat(3, axis=2) / 255.0


def occlude_sequence(video: np.ndarray, occ_type: str,
                     occlude_config: Optional[dict] = None,
                     rng: Optional[np.random.Generator] = None,
                     return_config: bool = False,
                     landmarks: Optional[np.ndarray] = None,
                     yx_min: Optional[np.ndarray] = None,
                     patch_dir=None, fixlen: float = 0.0):
    """Corrupt frames [start, start+occ) with the requested degradation
    (ref: visual_corruption.py:180-236).

    occ_type: coco (object patch at lip landmark), hands (hand patch pinned
    below center), pixelate, blur. Deterministic replay: pass the recorded
    `occlude_config` (== Visual_Corruption metadata: occlude_img,
    occluder_size, start_pt_idx, offset, occ_len, start_fr); generation:
    pass rng + return_config=True to get the config for the JSON record.

    landmarks: (T, 68, 2) facial landmarks as (x, y); yx_min: (T, 2) crop
    origin per frame. When absent (mouth-ROI-only data) the anchor defaults
    to the lower-lip region of the crop.
    """
    t = video.shape[0]
    overlay_type = occ_type in ("coco", "hands")
    bank = OccluderBank(occ_type, patch_dir) if overlay_type else None

    if occlude_config is not None:
        cfg = dict(occlude_config)
        start, occ = cfg["start_fr"], cfg["occ_len"]
    else:
        assert rng is not None
        start, occ = occlusion_span(t, rng, fixlen)
        cfg = {"total_len": t, "start_fr": start, "occ_len": occ}
        if overlay_type:
            cfg["occlude_img"] = str(rng.choice(bank.names))
            cfg["occluder_size"] = (
                96 if occ_type == "hands" else int(rng.integers(30, 60))
            )
            # lower-lip landmark + random offset (ref: :195-197)
            cfg["start_pt_idx"] = int(rng.integers(55, 68))
            cfg["offset"] = int(rng.integers(10, 30))

    out = np.asarray(video, np.float32).copy()
    occluder = None
    if overlay_type:
        cfg.setdefault("occluder_size", 96 if occ_type == "hands" else 45)
        occluder, alpha = _occluder_for_config(occ_type, bank, cfg, rng)

    h, w = out.shape[1], out.shape[2]
    for i in range(start, min(start + occ, t)):
        if occ_type == "pixelate":
            out[i] = image_pixelate(out[i])
        elif occ_type == "blur":
            out[i] = image_blur(out[i])
        else:
            frame = out[i][..., None].repeat(3, axis=2)
            if occ_type == "hands":
                frame = overlay_image_hands(frame, occluder, alpha)
            else:
                if landmarks is not None:
                    x, y = landmarks[i][cfg.get("start_pt_idx", 57)]
                    oy = yx_min[i][0] if yx_min is not None else 0
                    ox = yx_min[i][1] if yx_min is not None else 0
                else:
                    # ROI-only data: anchor at the lower-lip region
                    x, y, oy, ox = w * 0.5, h * 0.65, 0, 0
                off = cfg.get("offset", 20)
                frame = overlay_image_alpha(
                    frame, occluder, int(y - oy - off), int(x - ox - off), alpha
                )
            out[i] = frame @ _RGB2GRAY

    out = out.astype(video.dtype) if np.issubdtype(video.dtype, np.integer) else out
    if return_config:
        return out, cfg
    return out, None
