"""tpuframe_torch's GLUE data against the JAX package's.

The four synthetic builders give the same arrays, bit for bit, from the
same seeds.  The tsv readers (SST-2; MNLI with ``-`` gold labels; STS-B
with unscored rows; CoLA's headerless four columns; CRLF line ends) give
the JAX readers' arrays on files the test writes, through the crc32 hash
fallback and through WordPiece.  The port's WordPiece tokenizer agrees
with the JAX one token for token on a ``vocab.txt`` the test writes
(accents, CJK, punctuation, over-long words, pair truncation).  STS-B's
f32 labels stay f32 through the loader under a bf16 config.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpuframe.data import datasets as jax_ds  # noqa: E402
from tpuframe.data import wordpiece as jax_wp  # noqa: E402
from tpuframe_torch.data import datasets as port_ds  # noqa: E402
from tpuframe_torch.data import wordpiece as port_wp  # noqa: E402
from tpuframe_torch.data.pipeline import ShardedLoader  # noqa: E402

VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "quick", "brown", "fox", "jump", "##ed", "##s", "over", "a",
    "lazy", "dog", "un", "##believ", "##able", "!", ",", ".", "'", "cafe",
    "it", "was", "good", "bad", "movie", "this", "film", "is", "$", "^",
    "中", "文", "naive", "resume", "-", "?",
]

SENTENCES = [
    "The quick brown fox jumped over a lazy dog!",
    "unbelievable, it was GOOD.",
    "café dog naïve Résumé",          # accents stripped
    "it's a movie?",                   # apostrophe, question mark
    "xyzzyplugh dog",                  # unknown word -> [UNK]
    "中文 film 中文字",                 # CJK isolated per character
    "$5 ^ the-dog\tis　good",      # ASCII punctuation, tab, ideographic space
    "a" * 120 + " dog",                # over-long word -> [UNK]
    "this film is unbelievable",
]

PAIRS = [("the quick fox jumped over the lazy dog", "a dog"),
         ("this film", "it was good it was bad it was good"),
         ("the dog the dog", "the fox the fox")]   # a tie: B loses first


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("wp") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    return str(p)


def _same(got, want):
    assert set(got.columns) == set(want.columns)
    for k, w in want.columns.items():
        g = got.columns[k]
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", ["glue_sst2", "glue_mnli", "glue_stsb",
                                  "glue_cola"])
def test_synthetic_builders_are_bit_equal(name):
    kw = dict(seq_len=64, vocab_size=1024, synthetic_size=200)
    got = port_ds.build(name, None, **kw)
    want = getattr(jax_ds, name)(None, **kw)
    for g, w in zip(got, want):
        _same(g, w)
    assert len(got[1]) == 64


def test_tokenizer_matches_jax_token_for_token(vocab_file):
    tok, ref = (port_wp.WordPieceTokenizer(vocab_file),
                jax_wp.WordPieceTokenizer(vocab_file))
    for s in SENTENCES:
        assert tok.tokenize(s) == ref.tokenize(s), s
    assert "[UNK]" in tok.tokenize(SENTENCES[7])
    assert tok.tokenize("café naïve") == ["cafe", "naive"]
    for texts, max_len in ((SENTENCES, 16), (PAIRS, 10), (PAIRS, 7)):
        got = tok.encode_batch(texts, max_len=max_len)
        want = ref.encode_batch(texts, max_len=max_len)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert tok(SENTENCES, max_length=12)["input_ids"].shape == (9, 12)


def test_tokenizer_reads_local_paths_only(vocab_file):
    with pytest.raises(NotImplementedError, match="local"):
        port_wp.WordPieceTokenizer("gs://bucket/vocab.txt")
    with pytest.raises(ValueError, match="missing"):
        port_wp.WordPieceTokenizer({"[PAD]": 0})


SST2 = "sentence\tlabel\n" + "\n".join(
    f"{s}\t{i % 2}" for i, s in enumerate(SENTENCES)) + "\n"
MNLI = ("index\tgenre\tsentence1\tsentence2\tlabel1\tgold_label\n"
        "0\tfiction\tthe quick fox\ta dog\tneutral\tneutral\n"
        "1\tfiction\tit was good\tit was bad\tcontradiction\tcontradiction\n"
        "2\tslate\tthis film\tthe movie\tneutral\t-\n"
        "3\tslate\tshort row\n"
        "4\tslate\tthe dog the dog the dog\tthe fox\tentailment\t"
        "entailment\n")
STSB = ("index\tgenre\tfilename\tyear\told_index\tsource1\tsource2\t"
        "sentence1\tsentence2\tscore\n"
        "0\tmain\tf\t2012\t1\ta\tb\tthe quick fox\ta quick fox\t4.2\n"
        "1\tmain\tf\t2012\t2\ta\tb\tit was good\tit was bad\t0.75\n"
        "2\tmain\tf\t2012\t3\ta\tb\tunscored row\there\t\n"
        "3\tmain\tf\t2012\t4\ta\tb\tthis film\tthe movie\t5.000\n")
COLA = ("gj04\t1\t\tThe quick brown fox jumped.\n"
        "gj04\t0\t*\tDog the lazy over.\n"
        "bad row without columns\n"
        "cj99\t1\t\tit was good, this film!\n")
FILES = {"glue_sst2": (SST2, ("train.tsv", "dev.tsv")),
         "glue_mnli": (MNLI, ("train.tsv", "dev_matched.tsv")),
         "glue_stsb": (STSB, ("train.tsv", "dev.tsv")),
         "glue_cola": (COLA, ("train.tsv", "dev.tsv"))}
ROWS = {"glue_sst2": 9, "glue_mnli": 3, "glue_stsb": 3, "glue_cola": 3}


@pytest.mark.parametrize("crlf", [False, True], ids=["lf", "crlf"])
@pytest.mark.parametrize("vocab", [False, True], ids=["hash", "wordpiece"])
@pytest.mark.parametrize("name", sorted(FILES))
def test_tsv_readers_match_jax(tmp_path, vocab_file, name, vocab, crlf):
    text, files = FILES[name]
    if crlf:
        text = text.replace("\n", "\r\n")
    for f in files:
        (tmp_path / f).write_text(text)
    kw = dict(seq_len=12, vocab_size=1024,
              vocab_file=vocab_file if vocab else None)
    got = port_ds.build(name, str(tmp_path), **kw)
    want = getattr(jax_ds, name)(str(tmp_path), **kw)
    for g, w in zip(got, want):
        _same(g, w)
    assert len(got[0]) == ROWS[name]
    if name == "glue_mnli":
        np.testing.assert_array_equal(got[0].columns["label"], [1, 2, 0])
        assert got[0].columns["token_type_ids"].any()
    if name == "glue_stsb":
        assert got[0].columns["label"].dtype == np.float32
        np.testing.assert_allclose(got[0].columns["label"], [4.2, 0.75, 5.0])


def test_vocab_txt_in_data_dir_is_picked_up(tmp_path):
    (tmp_path / "train.tsv").write_text(SST2)
    (tmp_path / "dev.tsv").write_text(SST2)
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    got, _ = port_ds.glue_sst2(str(tmp_path), seq_len=16)
    want, _ = jax_ds.glue_sst2(str(tmp_path), seq_len=16)
    _same(got, want)
    assert got.columns["input_ids"][0, 0] == VOCAB.index("[CLS]")


def test_missing_explicit_vocab_and_remote_paths_raise(tmp_path):
    (tmp_path / "train.tsv").write_text(SST2)
    with pytest.raises(FileNotFoundError, match="vocab_file"):
        port_ds.glue_sst2(str(tmp_path),
                          vocab_file=str(tmp_path / "nope.txt"))
    with pytest.raises(NotImplementedError, match="local"):
        port_ds.glue_cola("gs://bucket/cola")


def test_stsb_labels_stay_f32_through_the_loader():
    train, _ = port_ds.glue_stsb(None, seq_len=32, vocab_size=512,
                                 synthetic_size=64)
    loader = ShardedLoader(train, 8, cast_floats=torch.bfloat16, world=1,
                           rank=0)
    batch = next(iter(loader))
    assert batch["label"].dtype == torch.float32
    assert batch["input_ids"].dtype == torch.int32
    want = train.columns["label"][loader._epoch_order(0)[:8]]
    np.testing.assert_array_equal(batch["label"].numpy(), want)
