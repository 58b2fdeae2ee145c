"""The port's copies of `data/packed.py`, `utils/prefetch.py` and
`collate.prefetch_epoch_batches` against the JAX package's: the same
files byte for byte, the same windows and mixtures, the same batches; and
`cli.finetune_ger --data_prefetch` on the CPU."""

import time

import numpy as np
import pytest

from dualhyp_tpu.data import collate as jcollate
from dualhyp_tpu.data import hypotheses as jhyp
from dualhyp_tpu.data import packed as jpacked
from dualhyp_tpu.utils.prefetch import prefetch as jax_prefetch
from dualhyp_tpu_torch.data import collate, hypotheses, packed, synthetic
from dualhyp_tpu_torch.utils.prefetch import prefetch
from tests.test_data import WordTokenizer

DOCS = [np.arange(1, 21), np.arange(100, 125), np.arange(7, 19)]


def _build(module, outdir, dtype):
    builder = module.PackedDatasetBuilder(outdir, "train", chunk_size=32, sep_token=0,
                                          dtype=dtype)
    for doc in DOCS:
        builder.add_array(doc)
    builder.write_reminder()
    return builder.filenames


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_packed_files_and_windows_match_jax(tmp_path, dtype):
    files = _build(packed, tmp_path / "port", dtype)
    want_files = _build(jpacked, tmp_path / "jax", dtype)
    assert len(files) == len(want_files) >= 2
    for a, b in zip(files, want_files):
        assert open(a, "rb").read() == open(b, "rb").read()
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=7),
               dict(shuffle=False, worker_index=1, num_workers=2)):
        got = list(packed.PackedDataset(files, block_size=8, **kw))
        want = list(jpacked.PackedDataset(want_files, block_size=8, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    stream = ",".join(map(str, np.concatenate(list(packed.PackedDataset(
        files, block_size=8, shuffle=False)))))
    assert all(",".join(map(str, doc)) in stream for doc in DOCS)


def test_shard_per_worker(tmp_path):
    builder = packed.PackedDatasetBuilder(tmp_path, "w", chunk_size=16)
    for i in range(6):
        builder.add_array(np.full(16, i))
    builder.write_reminder()
    seen = [{int(b[0]) for b in packed.PackedDataset(builder.filenames, block_size=16,
                                                     shuffle=False, worker_index=w,
                                                     num_workers=2)} for w in (0, 1)]
    assert seen[0] | seen[1] == set(range(6)) and seen[0].isdisjoint(seen[1])


def test_combined_dataset_matches_jax():
    a = [np.zeros(4, np.int64)] * 50
    b = [np.ones(4, np.int64)] * 50
    got = list(packed.CombinedDataset([iter(a), iter(b)], weights=[0.9, 0.1], seed=3))
    want = list(jpacked.CombinedDataset([iter(a), iter(b)], weights=[0.9, 0.1], seed=3))
    assert [int(x[0]) for x in got] == [int(x[0]) for x in want] and len(got) == 100
    assert np.mean([int(x[0] == 0) for x in got[:60]]) > 0.6


def test_prefetch_preserves_order_like_jax():
    items = list(range(57))
    assert list(prefetch(iter(items), depth=3)) == list(jax_prefetch(iter(items))) == items


def test_prefetch_reraises_generator_exception():
    def gen():
        yield 1
        yield 2
        raise ValueError("boom")

    out = []
    with pytest.raises(ValueError, match="boom"):
        for x in prefetch(gen()):
            out.append(x)
    assert out == [1, 2]


def test_prefetch_early_close_stops_producer():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()  # must not hang on a full queue
    time.sleep(0.3)  # the producer notices the stop event
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n < 10_000


def test_prefetch_epoch_batches_match_jax_and_sync(tmp_path):
    path = tmp_path / "h.json"
    synthetic.write_json(path, synthetic.make_records(n_uids=9, seed=2))
    tok = WordTokenizer()
    kw = dict(shuffle=True, seed=5, epoch=2, buckets=(256, 512))

    def dataset(module):  # the draws are seeded: a fresh dataset each time
        return module.DualHypothesesDataset("train", str(path), tok,
                                            prompts_format="DualHyp", seed=3)

    sync = list(collate.epoch_batches(dataset(hypotheses), 4, **kw))
    got = list(collate.prefetch_epoch_batches(dataset(hypotheses), 4, **kw))
    want = list(jcollate.prefetch_epoch_batches(dataset(jhyp), 4, **kw))
    assert len(got) == len(sync) == len(want) == 3
    for g, s, w in zip(got, sync, want):
        for k in ("input_ids", "labels", "valid"):
            np.testing.assert_array_equal(g[k], s[k], err_msg=k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["uids"] == w["uids"]


def test_finetune_ger_data_prefetch_on_cpu(tmp_path, monkeypatch):
    """`--data_prefetch` trains from the producer thread's batches: the
    same steps as the JAX package's prefetched epoch would feed."""
    import jax

    from dualhyp_tpu.ckpt import io as jio
    from dualhyp_tpu.models import gpt as jgpt
    from dualhyp_tpu_torch.cli import finetune_ger
    from tests import helpers
    from tests.test_cli import _write_tokenizer

    ckpt = tmp_path / "tiny-llama-test"
    ckpt.mkdir()
    vocab = _write_tokenizer(ckpt)
    cfg = helpers.tiny_llama_config(block_size=320, vocab_size=vocab, padding_multiple=8)
    jio.save_params(ckpt / "dualhyp_model.npz", jgpt.init(cfg, jax.random.key(0)))
    (ckpt / "dualhyp_config.json").write_text(cfg.to_json())
    for name, n in (("train", 4), ("val", 2)):
        synthetic.write_json(tmp_path / f"{name}.json",
                             synthetic.make_records(n_uids=n, n_hyps=2))
    monkeypatch.chdir(tmp_path)
    finetune_ger.main(["--train_path", str(tmp_path / "train.json"), "--val_path",
                       str(tmp_path / "val.json"), "--llm_checkpoint", str(ckpt),
                       "--device", "cpu", "--batch_size", "4", "--micro_batch_size", "2",
                       "--num_epochs", "1", "--lora_r", "4", "--lora_alpha", "8",
                       "--data_prefetch", "--exp_name", "prefetch"])
    assert (tmp_path / "runs" / "prefetch" / "model_lora_finetuned.npz").is_file()
