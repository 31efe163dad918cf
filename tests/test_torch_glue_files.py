"""The recipes' file front end against the JAX package, on files the tests
write: GLUE TSVs of all nine tasks (``utils/glue.py``: ``read_tsv``,
``featurize_pairs``, ``load_glue_task`` and its cache; ``bert_glue.load_glue``
on a task directory with ``--vocab``) and SQuAD JSON featurized with the
native WordPiece tokenizer's subword offsets (``bert_squad.load_squad`` with
``--tokenizer``), all bit-equal; and ``bert_glue`` / ``bert_squad`` run
from those files on the CPU."""
import json
import math

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from bayeformers_tpu.utils import glue as jglue
from bayeformers_tpu.utils import squad as jsquad
from bayeformers_tpu.workloads import bert_glue as jbert_glue
from bayeformers_tpu.workloads import bert_squad as jbert_squad
from bayeformers_tpu_torch.native import WordPieceTokenizer
from bayeformers_tpu_torch.utils import glue
from bayeformers_tpu_torch.utils import squad
from bayeformers_tpu_torch.workloads import bert_glue, bert_squad

WORDS = ["the", "a", "cat", "dog", "sat", "on", "mat", "ran", "fast", "slow", "book",
         "was", "written", "by", "ada", "love", "##lace", "in", "london", "paris", "who",
         "wrote", "where", "today", "long", "ago", "word", "##s", ".", ",", "?", "!",
         "is", "not", "it", "said", "he", "she", "went", "home"]
SENTENCE_WORDS = ["The", "cat", "dog", "sat", "on", "a", "mat", "ran", "fast", "slow",
                  "Paris", "London", "said", "went", "home", "today", "zebra", "café",
                  "Lovelace", "it's", "not"]


def bert_vocab(words=WORDS) -> list[str]:
    """A vocabulary laid out as BERT's: [PAD] 0, [UNK] 100, [CLS] 101, [SEP]
    102 (the featurizers' default ids), then ``words``."""
    return (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(words))


def write_vocab(path) -> str:
    path.write_text("\n".join(bert_vocab()), encoding="utf-8")
    return str(path)


def sentence(rng, lo=3, hi=14) -> str:
    return " ".join(rng.choice(SENTENCE_WORDS, size=rng.integers(lo, hi)).tolist()) + "."


def write_task(root, task: str, n_train=24, n_dev=10, seed=0) -> None:
    """``train.tsv`` and the task's dev file in its own column layout."""
    spec = glue.task_spec(task)
    rng = np.random.default_rng(seed)
    label_col = spec.label
    n_cols = max(spec.text_a, spec.text_b or 0, label_col) + 1 + (label_col < 0)

    def label():
        if spec.regression:
            return f"{rng.uniform(0, 5):.3f}"
        if spec.label_map is not None:
            return str(rng.choice(spec.label_map))
        return str(rng.integers(0, spec.n_labels))

    for name, n in (("train.tsv", n_train), (spec.dev_file, n_dev)):
        rows = [[f"h{c}" for c in range(n_cols)]] if spec.header else []
        for _ in range(n):
            row = [str(rng.integers(0, 1000)) for _ in range(n_cols)]
            row[spec.text_a] = sentence(rng)
            if spec.text_b is not None:
                row[spec.text_b] = sentence(rng)
            row[label_col] = label()
            rows.append(row)
        (root / name).write_text("\n".join("\t".join(r) for r in rows) + "\n",
                                 encoding="utf-8")


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("vocab") / "vocab.txt")


@pytest.mark.parametrize("task", sorted(glue.TASKS))
def test_load_glue_task_bit_equal(tmp_path, vocab, task):
    write_task(tmp_path, task)
    tok = WordPieceTokenizer(vocab)
    spec = glue.task_spec(task)
    path = str(tmp_path / "train.tsv")
    assert glue.read_tsv(path, spec.header) == jglue.read_tsv(path, spec.header)
    got = glue.load_glue_task(str(tmp_path), task, tok.tokenize, max_seq=24, cache=False)
    want = jglue.load_glue_task(str(tmp_path), task, tok.tokenize, max_seq=24, cache=False)
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(glue.FEATURE_KEYS)
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the cache: written once, then read back equal
    first = glue.load_glue_task(str(tmp_path), task, tok.tokenize, max_seq=24)
    assert (tmp_path / f"features_{task}_24.npz").exists()
    again = glue.load_glue_task(str(tmp_path), task, lambda t: 1 / 0, max_seq=24)
    for a, b in zip(first, again):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_featurize_pairs_truncation(vocab):
    tok = WordPieceTokenizer(vocab)
    rng = np.random.default_rng(4)
    pairs = [(sentence(rng, 10, 30), sentence(rng, 1, 40) if i % 3 else None)
             for i in range(12)]
    labels = rng.integers(0, 2, 12).tolist()
    for max_seq in (8, 16, 64):
        got = glue.featurize_pairs(pairs, labels, tok.tokenize, max_seq=max_seq,
                                   cls_id=7, sep_id=9, pad_id=3)
        want = jglue.featurize_pairs(pairs, labels, tok.tokenize, max_seq=max_seq,
                                     cls_id=7, sep_id=9, pad_id=3)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bert_glue_load_glue_from_tsvs(tmp_path, vocab):
    write_task(tmp_path, "mrpc", n_train=20, n_dev=8)
    got = bert_glue.load_glue(str(tmp_path), 1024, task="mrpc", vocab=vocab)
    want = jbert_glue.load_glue(str(tmp_path), 1024, task="mrpc", vocab=vocab)
    assert got[2] is False and want[2] is False
    for g, w in zip(got[:2], want[:2]):
        for k in w:
            assert g[k].dtype == np.asarray(w[k]).dtype
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
    # without a vocabulary the directory is not read: the synthetic stand-in
    assert bert_glue.load_glue(str(tmp_path), 1024)[2]


def test_bert_glue_runs_from_tsvs(tmp_path, vocab):
    data = tmp_path / "mrpc"
    data.mkdir()
    write_task(data, "mrpc", n_train=16, n_dev=8)
    score = bert_glue.train(data=str(data), vocab=vocab, task="mrpc", size="tiny",
                            epochs=1, b_epochs=1, samples=2, batch_size=4,
                            limit_batches=2, device="cpu", logs=str(tmp_path / "logs"))
    assert 0.0 <= score <= 1.0
    assert (data / "features_mrpc_128.npz").exists()


def squad_json(seed=0, n=3) -> dict:
    """SQuAD v1.1 JSON whose answers sit in long contexts (several windows)."""
    rng = np.random.default_rng(seed)
    paragraphs = []
    for i in range(n):
        before = " ".join(rng.choice(SENTENCE_WORDS, size=20 + 7 * i).tolist())
        answer = "Ada Lovelace" if i % 2 else "Paris"
        context = f"{before} {answer} wrote a book in London long ago."
        paragraphs.append({"context": context, "qas": [{
            "id": f"q{i}", "question": "Who wrote the book?" if i % 2 else "Where?",
            "answers": [{"text": answer, "answer_start": len(before) + 1}]}]})
    return {"data": [{"paragraphs": paragraphs}]}


def test_squad_features_bit_equal(tmp_path, vocab):
    tok = WordPieceTokenizer(vocab)
    path = tmp_path / "train-v1.1.json"
    path.write_text(json.dumps(squad_json()))
    examples = squad.load_squad_json(str(path))
    for training in (True, False):
        kw = dict(max_seq=32, doc_stride=8, is_training=training,
                  offsets_fn=tok.tokenize_with_offsets)
        got = squad.featurize(examples, tok.tokenize, **kw)
        want = jsquad.featurize(examples, tok.tokenize, **kw)
        assert len(got) == len(want) > len(examples)
        assert got == want


def test_load_squad_with_tokenizer_bit_equal(tmp_path, vocab):
    """``--tokenizer`` as a vocab.txt or a directory holding one: the port's
    features (cached next to the JSON) equal the JAX package's."""
    for split in ("train", "dev"):
        for d in ("port", "jax"):
            (tmp_path / d).mkdir(exist_ok=True)
            (tmp_path / d / f"{split}-v1.1.json").write_text(json.dumps(squad_json(1)))
    (tmp_path / "tok").mkdir()
    write_vocab(tmp_path / "tok" / "vocab.txt")
    wp = WordPieceTokenizer(bert_squad.wordpiece_vocab(str(tmp_path / "tok")))
    got = bert_squad.load_squad(str(tmp_path / "port"), wp.tokenize, 1024, 384,
                                offsets_fn=wp.tokenize_with_offsets)
    want = jbert_squad.load_squad(str(tmp_path / "jax"), vocab, 1024, 384)
    assert got[4] is False and want[4] is False
    for g, w in zip(got[:2], want[:2]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
    assert got[2] == list(want[2]) and got[3] == list(want[3])
    assert list((tmp_path / "port").glob("features_384_128.pkl"))
    with pytest.raises(ValueError, match="vocab.txt"):
        bert_squad.wordpiece_vocab(str(tmp_path / "port"))


def test_bert_squad_runs_with_tokenizer(tmp_path, vocab):
    data = squad_json(2, n=4)
    for split in ("train", "dev"):
        (tmp_path / f"{split}-v1.1.json").write_text(json.dumps(data))
    score = bert_squad.train(data_dir=str(tmp_path), tokenizer=vocab, size="tiny",
                             device="cpu", epochs=1, b_epochs=1, samples=2, batch_size=2,
                             max_seq=48, doc_stride=16, limit_batches=2,
                             logs=str(tmp_path / "logs"))
    assert math.isfinite(score) and 0.0 <= score <= 100.0
    with pytest.raises(ValueError, match="vocab.txt"):
        bert_squad.train(data_dir=str(tmp_path), tokenizer=str(tmp_path / "logs"),
                         size="tiny", device="cpu", logs=str(tmp_path / "logs"))


@pytest.mark.parametrize("workload", [bert_glue, bert_squad])
def test_hypersearch_flag_runs_the_trials(workload, tmp_path, monkeypatch, capsys, vocab):
    """``--hypersearch N``: N trials of the reference's search, each a run
    named by its sampled delta and weight decay, and the best reported."""
    if workload is bert_glue:
        (tmp_path / "mrpc").mkdir()
        write_task(tmp_path / "mrpc", "mrpc", n_train=8, n_dev=8)
        data = ["--data", str(tmp_path / "mrpc"), "--vocab", vocab]
    else:
        data = ["--max-seq", "32", "--data-dir", str(tmp_path / "none")]
    monkeypatch.setattr("sys.argv", [
        workload.__name__, "--size", "tiny", "--device", "cpu", "--epochs", "1",
        "--b-epochs", "1", "--samples", "2", "--batch-size", "4", "--limit-batches", "1",
        "--logs", str(tmp_path), "--hypersearch", "2", "--seed", "3"] + data)
    workload.main()
    assert "best score=" in capsys.readouterr().out
    runs = sorted(p.name for p in tmp_path.glob("*.jsonl"))
    assert len(runs) == 2 and all("DELTA_" in r and "WEIGHT_DECAY_" in r for r in runs)
