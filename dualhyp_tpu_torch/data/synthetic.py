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

from dualhyp_tpu_torch.data.tokenizer import WHISPER_LANGUAGES

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


# the symbols Whisper's non-speech suppression looks up (`infer.beam_search.
# non_speech_token_ids`), each a token of the synthetic Whisper vocabulary
_NON_SPEECH = (list('"#()*+/:;<=>@[\\]^_`{|}~「」『』-\'♩♪♫♬♭♮♯')
               + "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split())


def whisper_vocabulary(n_text: int = 50257, n_timestamps: int = 1501) -> dict:
    """{token: id} of a synthetic Whisper-shaped vocabulary: `n_text` text
    tokens (the non-speech symbols, "<unk>", then words "w<id>"), then
    large-v3's specials in its order (`<|endoftext|>` = n_text,
    `<|startoftranscript|>`, 100 languages, `<|translate|>`,
    `<|transcribe|>`, `<|startoflm|>`, `<|startofprev|>`, `<|nospeech|>`,
    `<|notimestamps|>`), then the timestamps `<|0.00|>`... 0.02 s apart. At
    the defaults: 51866 tokens, `<|endoftext|>` 50257, `<|0.00|>` 50365."""
    text = list(_NON_SPEECH) + ["<unk>"]
    text += [f"w{i}" for i in range(len(text), n_text)]
    specials = (["<|endoftext|>", "<|startoftranscript|>"]
                + [f"<|{code}|>" for code in WHISPER_LANGUAGES]
                + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
                   "<|nospeech|>", "<|notimestamps|>"]
                + [f"<|{i * 0.02:.2f}|>" for i in range(n_timestamps)])
    return {tok: i for i, tok in enumerate(text[:n_text] + specials)}


def whisper_tokenizer_json(n_text: int = 50257, n_timestamps: int = 1501) -> dict:
    """The `tokenizer.json` of `whisper_vocabulary`: a word-level model
    split on whitespace and punctuation, every non-text token special (so
    `decode(..., skip_special_tokens=True)` drops it)."""
    vocab = whisper_vocabulary(n_text, n_timestamps)
    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [{"id": i, "content": tok, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for tok, i in vocab.items() if i >= n_text],
        "normalizer": None,
        "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": None,
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
    }
