"""Text cleaning + label-file loading vs reference behavior."""
import numpy as np

from textgcn.text.clean import StringProcess, clean_corpus_lines
from textgcn.text.datasets import load_labels


def test_clean_str_reference_rules():
    sp = StringProcess()
    # contraction splitting is case-sensitive and runs before lowercasing,
    # exactly as in the reference (data_processor.py:61-99): uppercase
    # "DON'T" is NOT split, lowercase "don't" is.
    assert sp.clean_str("It's DON'T-stop (now)!") == (
        "it 's don't stop \\( now \\) !"
    )
    assert sp.clean_str("don't you've we're") == "do n't you 've we 're"
    assert sp.clean_str("Hello,world?") == "hello , world \\?"
    assert sp.clean_str("a  b\t c") == "a b c"
    # non-alphanumerics outside the keep-set become spaces
    assert sp.clean_str("foo@bar.com") == "foo bar com"


def test_replace_num_and_urls():
    sp = StringProcess()
    assert sp.replace_num("abc 123 -4.5 x") == "abc <num> <num> x"
    assert (
        sp.replace_urls("see https://example.com/x?q=1 now")
        == "see <url> now"
    )


def test_clean_corpus_min_freq_and_stopwords():
    # 'rare' appears once → dropped for non-mr; stopword 'the' dropped
    lines = [b"the cat sat"] * 5 + [b"the cat rare"]
    out = clean_corpus_lines(lines, dataset="R8", min_word_freq=5)
    assert out[0] == "cat sat"
    assert out[5] == "cat"  # 'rare' dropped (freq 1), 'the' stopword


def test_clean_corpus_mr_keeps_everything():
    lines = [b"the movie was rare"]
    out = clean_corpus_lines(lines, dataset="mr")
    assert out[0] == "the movie was rare"


def test_load_labels(tmp_path):
    p = tmp_path / "ds.txt"
    p.write_text(
        "0\ttrain\tearn\n1\ttest\tacq\n2\ttrain\tacq\n3\t20news-bydate-train\tearn\n"
        "4\ttraining\tcrude\n5\ttest\tearn\n"
    )
    labels = load_labels(str(p))
    assert labels.n_classes == 3
    assert labels.label_names == ["acq", "crude", "earn"]  # sorted
    np.testing.assert_array_equal(labels.train_idx, [0, 2, 3, 4])
    np.testing.assert_array_equal(labels.test_idx, [1, 5])
    # ids follow sorted label names
    assert labels.target.tolist() == [2, 0, 0, 2, 1, 2]


def test_load_labels_real_r8():
    labels = load_labels("data/text_dataset/R8.txt")
    assert labels.n_docs == 7674
    assert labels.n_classes == 8
    assert len(labels.train_idx) == 5485
    assert len(labels.test_idx) == 2189


def test_clean_str_backslash_punct_quirk():
    """Reference data_processor.py:92-94 writes literal \\( \\) \\? tokens
    (unknown non-letter escapes pass through re.sub replacements); the shipped
    clean corpora contain them, so the cleaner must reproduce them."""
    from textgcn.text.clean import StringProcess

    sp = StringProcess()
    assert sp.clean_str("who cares? (really)") == r"who cares \? \( really \)"


def test_clean_corpus_matches_shipped_mr_artifact():
    """Full-corpus byte parity with the reference's shipped clean corpus."""
    import os

    raw = "data/text_dataset/corpus/mr.txt"
    shipped = "data/text_dataset/clean_corpus/mr.txt"
    if not (os.path.exists(raw) and os.path.exists(shipped)):
        import pytest

        pytest.skip("mr corpus not present")
    from textgcn.text.clean import clean_corpus_lines

    with open(raw, "rb") as f:
        cleaned = clean_corpus_lines(f, dataset="mr")
    with open(shipped, "r", encoding="utf-8") as f:
        expect = [ln.rstrip("\n").rstrip(" ") for ln in f]
    assert len(cleaned) == len(expect)
    assert cleaned == expect
