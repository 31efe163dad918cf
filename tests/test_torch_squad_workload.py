"""``workloads/bert_squad.py`` on the CPU at the tiny size: phases A-D on
the synthetic stand-in (span accuracy) and on SQuAD-format JSON that the
test writes, featurised with a toy tokenizer (EM/F1 and the draws'
spread); its refusals name their ROADMAP items. And ``bert_glue`` with a
sibling family.
"""
import json
import math

import numpy as np
import pytest

from bayeformers_tpu_torch.workloads import bert_glue, bert_squad
from test_torch_squad import EXAMPLES, _toy_tokenize
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TINY = dict(size="tiny", device="cpu", epochs=1, b_epochs=1, samples=4, batch_size=2,
            max_seq=48, limit_batches=2)


def test_bert_squad_synthetic_runs_on_cpu(tmp_path):
    score = bert_squad.train(model="distilbert-base-uncased", logs=str(tmp_path),
                             data_dir=str(tmp_path / "none"), **TINY)
    assert math.isfinite(score) and 0.0 <= score <= 1.0


def test_bert_squad_json_gives_em_f1(tmp_path, capsys):
    """Real-format data with a ``tokenize`` callable: the features are
    built (and cached next to the JSON), and phases C and D score EM/F1
    and the draws' spread."""
    data = {"data": [{"paragraphs": [
        {"context": ex["context"], "qas": [{"id": f"{ex['qid']}-{i}",
                                            "question": ex["question"],
                                            "answers": ex["answers"]}]}
        for ex in EXAMPLES for i in range(2)]}]}
    for split in ("train", "dev"):
        (tmp_path / f"{split}-v1.1.json").write_text(json.dumps(data))
    score = bert_squad.train(logs=str(tmp_path / "logs"), data_dir=str(tmp_path),
                             tokenize=_toy_tokenize, doc_stride=16, **TINY)
    assert math.isfinite(score) and 0.0 <= score <= 100.0
    out = capsys.readouterr().out
    assert "exact_match" in out and "span_agreement" in out
    assert list(tmp_path.glob("features_48_16.pkl"))
    train, dev, feats, examples, synthetic = bert_squad.load_squad(
        str(tmp_path), _toy_tokenize, 1024, 48, doc_stride=16)
    assert not synthetic and len(feats) == dev["input_ids"].shape[0] > len(examples)
    assert set(train) == {"input_ids", "attention_mask", "token_type_ids",
                          "start_positions", "end_positions"}


def test_bert_squad_refusals_name_their_items(tmp_path):
    """Sequence parallelism names its ROADMAP item (6(d)); a ``--tokenizer``
    that is neither a vocab.txt nor a directory holding one names what it
    needs."""
    with pytest.raises(NotImplementedError, match=r"item 6\(d\)"):
        bert_squad.train(logs=str(tmp_path), **dict(TINY, sp=2))
    with pytest.raises(ValueError, match="vocab.txt"):
        bert_squad.train(logs=str(tmp_path), **dict(TINY, tokenizer=str(tmp_path)))


def test_bert_glue_runs_a_sibling_family(tmp_path):
    """``bert_glue`` takes ALBERT (its shared layer) through phases A-D."""
    score = bert_glue.train(model_name="albert-base-v2", size="tiny", device="cpu",
                            logs=str(tmp_path), epochs=1, b_epochs=1, limit_batches=2,
                            samples=4)
    assert np.isfinite(score)
