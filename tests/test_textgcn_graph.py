"""TextGCN doc-word graph: TF-IDF and PMI vs hand-computed oracles."""
import numpy as np

from textgcn.graph.build_textgcn import (
    TextGCNGraphBuilder,
    build_vocab,
    doc_word_tfidf,
    window_word_incidence,
    word_word_pmi,
)


def test_build_vocab_sorted():
    docs = ["b a", "c a"]
    assert build_vocab(docs) == ["a", "b", "c"]


def test_doc_word_tfidf_oracle():
    docs = ["a a b", "a c"]
    vocab = ["a", "b", "c"]
    r, c, w = doc_word_tfidf(docs, vocab)
    tf = {(0, 0): 2, (0, 1): 1, (1, 0): 1, (1, 2): 1}
    idf = {0: np.log(2 / 2), 1: np.log(2 / 1), 2: np.log(2 / 1)}
    got = dict(zip(zip(r.tolist(), c.tolist()), w))
    for (d, t), count in tf.items():
        np.testing.assert_allclose(got[(d, t)], count * idf[t], atol=1e-12)


def test_window_incidence_short_doc_single_window():
    docs = ["a b c"]
    inc = window_word_incidence(docs, ["a", "b", "c"], window_size=20)
    assert inc.shape == (1, 3)
    assert inc.sum() == 3


def test_window_incidence_sliding():
    docs = ["a b c d"]
    inc = window_word_incidence(docs, ["a", "b", "c", "d"], window_size=2)
    # windows: ab, bc, cd
    assert inc.shape == (3, 4)
    np.testing.assert_array_equal(
        inc.toarray(), [[1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 1, 1]]
    )


def test_pmi_oracle():
    # 3 windows: {a,b}, {a,b}, {a,c}  (window larger than docs)
    docs = ["a b", "a b", "a c"]
    vocab = ["a", "b", "c"]
    i, j, pmi = word_word_pmi(docs, vocab, window_size=20)
    got = dict(zip(zip(i.tolist(), j.tolist()), pmi))
    # p(a)=1, p(b)=2/3, p(ab)=2/3 → pmi = log(1) = 0 → dropped (not > 0)
    assert (0, 1) not in got
    # p(c)=1/3, p(ac)=1/3 → pmi = log((1/3)/(1*1/3)) = 0 → dropped
    assert (0, 2) not in got
    # now a corpus with positive association: b,c always together, a separate
    docs2 = ["b c", "b c", "a a"]
    i2, j2, p2 = word_word_pmi(docs2, ["a", "b", "c"], window_size=20)
    got2 = dict(zip(zip(i2.tolist(), j2.tolist()), p2))
    want = np.log((2 / 3) / ((2 / 3) * (2 / 3)))
    np.testing.assert_allclose(got2[(1, 2)], want, atol=1e-12)


def test_builder_end_to_end(tmp_path):
    docs = ["apple banana fruit", "banana fruit sweet", "car road fast",
            "road car drive"]
    b = TextGCNGraphBuilder("toy", verbose=False)
    g = b.build(docs)
    assert g.num_docs == 4
    assert g.num_words == len(set(" ".join(docs).split()))
    assert (g.src[: g.n_doc_word_edges] < 4).all()
    assert (g.dst >= 4).all()
    b.save(str(tmp_path))
    assert (tmp_path / "toy_docword.txt").exists()
    assert (tmp_path / "toy_docword_vocab.txt").exists()
