"""Hypotheses JSON datasets + prompt packing.

A copy of the GER, DualHyp and RelPrompt (mask) datasets of
`dualhyp_tpu/data/hypotheses.py`.

Host-side (numpy/python) data pipeline with the same record semantics as the
reference datasets (ref: data/av_dataset.py:21-647):

  * records are grouped by `Uid`; one (or two, for DualHyp) corruption
    variants are drawn per epoch visit (ref: av_dataset.py:121-124, 343-346)
  * "_pretrain" JSON files contribute a second uid pool
    (ref: av_dataset.py:56-79)
  * other-hypotheses are subsampled order-preservingly
    (ref: data/utils.py:250-255)
  * the packed example is prompt(+hyps) + caption + eos, with labels masked
    to IGNORE(-1) over the prompt region (ref: av_dataset.py:210-256)
  * `max_input_length` truncates ids and labels (ref: av_dataset.py:138-140)

Unlike the reference's torch DataLoader collate (pad to batch max,
ref: av_dataset.py:258-292), batches are padded to bucket lengths so a few
prompt shapes cover the whole dataset (see collate.py).

The GER/DualHyp training scripts run with audio/visual corruption disabled
(text-only effective path, ref: scripts/finetune_ger.sh) — waveform/ROI
loading is therefore opt-in here and only needed by the RelPrompt stack.
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from dualhyp_tpu_torch.data.prompts import get_prompts_format

IGNORE_INDEX = -1


def ordered_sample(items: Sequence, k: int, rng: random.Random) -> list:
    """Random subsample that preserves original order
    (ref: data/utils.py:250-255)."""
    idx = sorted(rng.sample(range(len(items)), k))
    return [items[i] for i in idx]


def load_hypotheses_json(json_path) -> tuple:
    """Load one or many hypotheses JSON files.

    Returns (records, pretrain_records); files whose name contains
    "_pretrain" go to the second pool (ref: av_dataset.py:56-66).
    """
    records, pretrain = [], []
    paths = [json_path] if isinstance(json_path, str) else list(json_path)
    for path in paths:
        with open(path, encoding="utf-8") as fp:
            data = json.load(fp)
        (pretrain if "_pretrain" in str(path) else records).extend(data)
    return records, pretrain


def group_by_uid(records, pretrain):
    """uid -> list of corruption variants, preserving first-seen uid order
    (ref: av_dataset.py:68-79)."""
    uid2sample: Dict[str, list] = defaultdict(list)
    order: List[str] = []
    for rec in records:
        uid = rec["Uid"]
        if uid not in uid2sample:
            order.append(uid)
        uid2sample[uid].append(rec)
    for rec in pretrain:
        uid = rec["Uid"] + "_pretrain"
        if uid not in uid2sample:
            order.append(uid)
        uid2sample[uid].append(rec)
    return uid2sample, order


@dataclass
class PackedExample:
    uid: str
    ground_truth: str
    prompt: str            # full prompt incl. caption + eos
    prompt_no_response: str
    input_ids: List[int]
    input_ids_no_response: List[int]
    labels: List[int]
    audio_bin_labels: Optional[List[str]] = None
    video_bin_labels: Optional[List[str]] = None
    records: tuple = ()


def pack_tokens(tokenizer, prompt_no_response: str, caption: str,
                eos_token: str, max_input_length: int = -1,
                chat_template: bool = False) -> dict:
    """Tokenise and build (-1)-masked labels (ref: av_dataset.py:225-249)."""
    if chat_template:
        messages = [
            {"role": "system", "content": "You are a helpful AI assistant."},
            {"role": "user", "content": prompt_no_response},
        ]
        prompt_ids = tokenizer.apply_chat_template(
            messages, tokenize=True, add_generation_prompt=True
        )
        answer_ids = tokenizer(caption, add_special_tokens=False)["input_ids"]
        answer_ids = answer_ids + [tokenizer.eos_token_id]
        input_ids = list(prompt_ids) + list(answer_ids)
        no_resp = list(prompt_ids)
        labels = [IGNORE_INDEX] * len(prompt_ids) + list(answer_ids)
    else:
        full_prompt = prompt_no_response + caption + eos_token
        no_resp = list(tokenizer.encode(prompt_no_response))
        input_ids = list(tokenizer.encode(full_prompt))
        labels = [IGNORE_INDEX] * len(no_resp) + input_ids[len(no_resp):]
    if max_input_length > 0:
        input_ids = input_ids[:max_input_length]
        labels = labels[:max_input_length]
    return {
        "input_ids": input_ids,
        "input_ids_no_response": no_resp,
        "labels": labels,
    }


class HypothesesDataset:
    """GER single-stream dataset (ref: data/av_dataset.py:21-323).

    Prompt = prompt_1 + best_hyp + prompt_2 + '\\n' + '\\n'.join(shuffled
    others) + prompt_3 (ref: av_dataset.py:222).
    """

    prompts_format_default = "GER"

    def __init__(
        self,
        split: str,
        json_path,
        tokenizer,
        max_input_length: int = -1,
        max_nhyps: Optional[int] = None,
        nhyps_key: str = "nhyps_asr",
        random_sample_nhyps: bool = True,
        prompts_format: Optional[str] = None,
        apply_chat_template: bool = False,
        language: Optional[str] = None,
        seed: int = 1337,
        media_loader: Optional[Callable] = None,
    ):
        assert split in ("train", "val", "test")
        self.split = split
        self.tokenizer = tokenizer
        self.max_input_length = max_input_length
        self.max_nhyps = max_nhyps
        self.nhyps_key = nhyps_key
        self.random_sample_nhyps = random_sample_nhyps
        self.apply_chat_template = apply_chat_template
        self.language = language
        self.media_loader = media_loader
        self.rng = random.Random(seed)

        records, pretrain = load_hypotheses_json(json_path)
        self.uid2sample, self.idx2uid = group_by_uid(records, pretrain)
        self.records = records

        fmt = get_prompts_format(prompts_format or self.prompts_format_default)
        self.prompt_1, self.prompt_2, self.prompt_3 = (
            fmt["prompt_1"],
            fmt["prompt_2"],
            fmt["prompt_3"],
        )
        if language is not None:
            # (ref: av_dataset.py:111-112)
            self.prompt_1 = self.prompt_1.replace(
                "speech recognition system", f"{language} speech recognition system"
            )
        self.eos_token = getattr(tokenizer, "eos_token", None) or "</s>"

    def __len__(self):
        return len(self.idx2uid)

    def get_max_seq_length(self):
        """(max_len, max_len, argmax) over packed examples, + mean printout
        (ref: av_dataset.py:294-305) — used to budget decode/cache sizes."""
        lengths = [len(self[i].input_ids) for i in range(len(self))]
        max_len = max(lengths)
        print(f"mean length = {sum(lengths) / len(lengths)}")
        return max_len, max_len, lengths.index(max_len)

    # ---- record selection ----
    def _draw(self, uid):
        return (self.rng.choice(self.uid2sample[uid]),)

    def _other_hyps(self, hyps):
        others = hyps[1 : self.max_nhyps] if self.max_nhyps is not None else hyps[1:]
        if self.random_sample_nhyps:
            others = ordered_sample(others, len(others), self.rng)
        return others

    # ---- prompt building ----
    def build_prompt(self, records) -> str:
        (rec,) = records
        hyps = rec[self.nhyps_key]["hyps"]
        others = self._other_hyps(hyps)
        return (
            self.prompt_1
            + hyps[0]
            + self.prompt_2
            + "\n"
            + "\n".join(others)
            + self.prompt_3
        )

    def __getitem__(self, idx) -> PackedExample:
        uid = self.idx2uid[idx]
        records = self._draw(uid)
        prompt_no_response = self.build_prompt(records)
        caption = records[0].get("Caption", "")
        toks = pack_tokens(
            self.tokenizer,
            prompt_no_response,
            caption,
            self.eos_token,
            self.max_input_length,
            self.apply_chat_template,
        )
        return PackedExample(
            uid=records[0].get("Uid", ""),
            ground_truth=caption,
            prompt=prompt_no_response + caption + self.eos_token,
            prompt_no_response=prompt_no_response,
            records=records,
            **toks,
        )


class DualHypothesesDataset(HypothesesDataset):
    """DualHyp: independent ASR + VSR hypothesis streams. Two variants are
    drawn per uid (audio corruption from #1, visual from #2 — decoupled,
    ref: av_dataset.py:343-350)."""

    prompts_format_default = "DualHyp"
    nhyps_key_asr = "nhyps_asr"
    nhyps_key_vsr = "nhyps_vsr"

    def _draw(self, uid):
        pool = self.uid2sample[uid]
        return tuple(self.rng.choices(pool, k=2))

    def build_prompt(self, records) -> str:
        rec_asr, rec_vsr = records
        asr = rec_asr[self.nhyps_key_asr]["hyps"]
        vsr = rec_vsr[self.nhyps_key_vsr]["hyps"]
        asr_others = self._other_hyps(asr)
        vsr_others = self._other_hyps(vsr)
        p1 = self.prompt_1.replace("<<<ASR_NHYPS>>>", asr[0]).replace(
            "<<<VSR_NHYPS>>>", vsr[0]
        )
        p2 = self.prompt_2.replace("<<<ASR_NHYPS>>>", "\n".join(asr_others)).replace(
            "<<<VSR_NHYPS>>>", "\n".join(vsr_others)
        )
        return p1 + p2 + self.prompt_3


class DualHypothesesMaskDataset(DualHypothesesDataset):
    """RelPrompt: DualHyp + ground-truth reliability masks injected into the
    prompt (training) or left as placeholders (inference)
    (ref: av_dataset.py:432-647)."""

    prompts_format_default = "RelPrompt"

    def __init__(
        self,
        *args,
        leave_masks: bool = False,
        mask_threshold: Optional[float] = None,
        time_window: float = 0.4,
        audio_corruption_enabled: bool = True,
        visual_corruption_enabled: bool = True,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.leave_masks = leave_masks
        self.mask_threshold = mask_threshold
        # 16 kHz audio / 25 fps video (ref: av_dataset.py:444-445)
        self.audio_chunk_size = int(16000 * time_window)
        self.video_chunk_size = int(25 * time_window)
        self.audio_corruption_enabled = audio_corruption_enabled
        self.visual_corruption_enabled = visual_corruption_enabled

    def __getitem__(self, idx) -> PackedExample:
        from dualhyp_tpu_torch.data import masks as mask_lib

        uid = self.idx2uid[idx]
        rec_asr, rec_vsr = self._draw(uid)

        if self.audio_corruption_enabled:
            audio_mask = mask_lib.frame_noise_mask(
                rec_asr["Audio_Corruption"], self.mask_threshold
            )
        else:
            audio_mask = ["C"] * rec_asr["Audio_Corruption"]["total_len"]
        if self.visual_corruption_enabled:
            vc = dict(rec_vsr["Visual_Corruption"])
            vc["snr"] = -100  # video corruption always counts as noise
            video_mask = mask_lib.frame_noise_mask(vc, self.mask_threshold)
        else:
            video_mask = ["C"] * rec_vsr["Visual_Corruption"]["total_len"]

        _, audio_bins = mask_lib.chunk_reliability(audio_mask, self.audio_chunk_size)
        _, video_bins = mask_lib.chunk_reliability(video_mask, self.video_chunk_size)

        prompt_no_response = self.build_mask_prompt(
            (rec_asr, rec_vsr), audio_bins, video_bins
        )
        caption = rec_asr.get("Caption", "")
        toks = pack_tokens(
            self.tokenizer,
            prompt_no_response,
            caption,
            self.eos_token,
            self.max_input_length,
            self.apply_chat_template,
        )
        return PackedExample(
            uid=rec_asr.get("Uid", ""),
            ground_truth=caption,
            prompt=prompt_no_response + caption + self.eos_token,
            prompt_no_response=prompt_no_response,
            audio_bin_labels=audio_bins,
            video_bin_labels=video_bins,
            records=(rec_asr, rec_vsr),
            **toks,
        )

    def build_mask_prompt(self, records, audio_bins, video_bins) -> str:
        rec_asr, rec_vsr = records
        asr = rec_asr[self.nhyps_key_asr]["hyps"]
        vsr = rec_vsr[self.nhyps_key_vsr]["hyps"]
        asr_others = self._other_hyps(asr)
        vsr_others = self._other_hyps(vsr)
        prompt = (
            self.prompt_1.replace("<<<ASR_BEST_NHYPS>>>", asr[0])
            .replace("<<<VSR_BEST_NHYPS>>>", vsr[0])
            .replace("<<<ASR_NHYPS>>>", "\n".join(asr_others))
            .replace("<<<VSR_NHYPS>>>", "\n".join(vsr_others))
        )
        if not self.leave_masks:
            prompt = prompt.replace("<<<ASR_MASKS>>>", "".join(audio_bins)).replace(
                "<<<VSR_MASKS>>>", "".join(video_bins)
            )
        return prompt + self.prompt_3
