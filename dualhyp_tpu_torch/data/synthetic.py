"""Synthetic hypotheses JSON generation.

Produces records with the same schema the reference's offline generators
emit (ref: data/make_json_asr.py:79-117, data/merge_json.py:8-68):
Uid / Caption / Clean_Wav / Noise_Wav / SNR / nhyps_asr / nhyps_vsr /
Audio_Corruption / Visual_Corruption / Noise_Category / WER_1st-hyp.

Used by the test-suite and the benchmark when no real LRS2 hypothesis JSONs
are present; the text is a deterministic word-noise model so WER improvements
are measurable.
"""

from __future__ import annotations

import json
import random
from typing import List

_WORDS = (
    "the quick brown fox jumps over a lazy dog while many people watch "
    "from their windows and talk about weather news sports music and art "
    "every day some things change but others stay just as they were before"
).split()


def _sentence(rng: random.Random, n_words: int) -> str:
    return " ".join(rng.choice(_WORDS) for _ in range(n_words))


def _corrupt(rng: random.Random, words: List[str], p: float) -> str:
    out = []
    for w in words:
        r = rng.random()
        if r < p * 0.5:
            out.append(rng.choice(_WORDS))  # substitution
        elif r < p * 0.75:
            continue  # deletion
        else:
            out.append(w)
            if r > 1 - p * 0.25:
                out.append(rng.choice(_WORDS))  # insertion
    return " ".join(out) if out else words[0]


def make_records(
    n_uids: int = 32,
    variants_per_uid: int = 1,
    n_hyps: int = 5,
    seed: int = 0,
    asr_noise: float = 0.25,
    vsr_noise: float = 0.45,
) -> list:
    rng = random.Random(seed)
    records = []
    for u in range(n_uids):
        caption = _sentence(rng, rng.randint(6, 14))
        words = caption.split()
        for v in range(variants_per_uid):
            total_audio = len(words) * 6400  # ~0.4 s per word at 16 kHz
            occ_a = rng.randint(total_audio // 8, total_audio // 2)
            start_a = rng.randint(0, total_audio - occ_a)
            total_video = len(words) * 10
            occ_v = rng.randint(total_video // 8, total_video // 2)
            start_v = rng.randint(0, total_video - occ_v)
            rec = {
                "Dataset": "synthetic",
                "Uid": f"uid{u:05d}",
                "Caption": caption,
                "Clean_Wav": f"/data/clean/uid{u:05d}.wav",
                "Noise_Wav": f"/data/noise/uid{u:05d}_{v}.wav",
                "Mouthroi": f"/data/roi/uid{u:05d}.hdf5",
                "Face_landmark": f"/data/lm/uid{u:05d}.pkl",
                "SNR": rng.choice([-5, 0, 5, 10]),
                "Noise_Category": ["babble", rng.choice(["coco", "hands", "pixelate", "blur"])],
                "nhyps_asr": {
                    "hyps": [_corrupt(rng, words, asr_noise * (1 + 0.2 * h)) for h in range(n_hyps)],
                    "scores": [round(-float(h) - rng.random(), 3) for h in range(n_hyps)],
                },
                "nhyps_vsr": {
                    "hyps": [_corrupt(rng, words, vsr_noise * (1 + 0.2 * h)) for h in range(n_hyps)],
                    "scores": [round(-float(h) - rng.random(), 3) for h in range(n_hyps)],
                },
                "Audio_Corruption": {
                    "total_len": total_audio,
                    "start_fr": start_a,
                    "occ_len": occ_a,
                    "snr": rng.choice([-5, 0, 5]),
                },
                "Visual_Corruption": {
                    "total_len": total_video,
                    "start_fr": start_v,
                    "occ_len": occ_v,
                },
                "WER_1st-hyp": round(rng.random() * 0.4, 3),
            }
            # overlay categories carry the occluder replay fields in the
            # released JSONs (data/corruption._occluder_for_config reads
            # occlude_img/occluder_size/start_pt_idx/offset)
            vis_cat = rec["Noise_Category"][1]
            if vis_cat in ("coco", "hands"):
                rec["Visual_Corruption"].update(
                    occlude_img=f"occluder_{rng.randint(0, 49):03d}.png",
                    occluder_size=(96 if vis_cat == "hands"
                                   else rng.randint(30, 59)),
                    start_pt_idx=rng.randint(55, 67),
                    offset=rng.randint(10, 29),
                )
            records.append(rec)
    return records


def write_json(path, records) -> None:
    with open(path, "w", encoding="utf-8") as fp:
        json.dump(records, fp, indent=1, ensure_ascii=False)


def word_vocabulary() -> List[str]:
    return sorted(set(_WORDS))
