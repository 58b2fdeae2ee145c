"""Join ASR and VSR hypothesis JSONs on Uid (ref: data/merge_json.py:8-68).

`nhyps` renames to `nhyps_asr`/`nhyps_vsr`; `Noise_Category` and
`WER_1st-hyp` become (asr, vsr) pairs; VSR-side media keys carry over.
Records missing hypotheses on either side are skipped and reported.

  python -m dualhyp_tpu_torch.data.merge asr.json vsr.json merged.json

A copy of `dualhyp_tpu/data/merge.py` (which imports no JAX), kept in the
port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import List, Tuple

VSR_KEYS = ("Mouthroi", "Video", "Face_landmark", "Visual_Corruption")
PAIRED_KEYS = ("Noise_Category", "WER_1st-hyp")


def merge_records(asr_list: list, vsr_list: list) -> Tuple[list, List[str]]:
    asr_by_uid = {r["Uid"]: r for r in asr_list if r.get("Uid")}
    vsr_by_uid = {r["Uid"]: r for r in vsr_list if r.get("Uid")}
    merged, skipped = [], []
    for uid in sorted(set(asr_by_uid) & set(vsr_by_uid)):
        asr, vsr = asr_by_uid[uid], vsr_by_uid[uid]
        if not asr.get("nhyps") or not vsr.get("nhyps"):
            skipped.append(uid)
            continue
        rec = {}
        for key, value in asr.items():
            rec["nhyps_asr" if key == "nhyps" else key] = value
        rec["nhyps_vsr"] = vsr["nhyps"]
        for key in PAIRED_KEYS:
            if key in vsr:
                rec[key] = (asr.get(key), vsr[key])
        for key in VSR_KEYS:
            if key in vsr:
                rec[key] = vsr[key]
        merged.append(rec)
    return merged, skipped


def merge_json_files(asr_path, vsr_path, out_path) -> List[str]:
    with open(asr_path, encoding="utf-8") as fp:
        asr_list = json.load(fp)
    with open(vsr_path, encoding="utf-8") as fp:
        vsr_list = json.load(fp)
    merged, skipped = merge_records(asr_list, vsr_list)
    out_path = Path(out_path)
    if out_path.exists():
        raise FileExistsError(f"{out_path} already exists; refusing to overwrite")
    with open(out_path, "w", encoding="utf-8") as fp:
        json.dump(merged, fp, indent=4, ensure_ascii=False)
    return skipped


if __name__ == "__main__":
    if len(sys.argv) != 4:
        raise SystemExit(__doc__)
    skipped = merge_json_files(*sys.argv[1:4])
    if skipped:
        print(f"skipped uids without hypotheses: {skipped}")
