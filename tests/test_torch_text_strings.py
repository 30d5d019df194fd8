"""The port's ``text`` (``viterbi_decode``, ``ViterbiDecoder``, the
dataset stand-ins) and ``strings`` against the JAX package on the CPU.

Viterbi scores agree within 1e-5 and paths exactly, on seeded float32
potentials with no ties. The strings are host data: equal lists.

Reference fault shown here: the reference's ``viterbi_decode`` ignores
``lengths``. The port's best path ends at each sequence's own length: it
equals a brute-force search over that length, equals the reference's
where every length is full, and reads 0 past the length.
"""
import itertools

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _brute(pot, trans, n):
    best, best_path = -np.inf, None
    for tags in itertools.product(range(pot.shape[-1]), repeat=n):
        s = pot[0, tags[0]] + sum(trans[tags[i - 1], tags[i]] + pot[i, tags[i]]
                                  for i in range(1, n))
        if s > best:
            best, best_path = s, tags
    return best, best_path


def _potentials(seed, b=3, t=5, n=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, n).astype(np.float32),
            rng.randn(n, n).astype(np.float32))


def test_viterbi_full_length_like_jax_and_brute_force():
    pot, trans = _potentials(0)
    got_s, got_p = tp.text.viterbi_decode(tp.to_tensor(pot),
                                          tp.to_tensor(trans))
    want_s, want_p = jp.text.viterbi_decode(jp.to_tensor(pot),
                                            jp.to_tensor(trans))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s.numpy()),
                               atol=TOL)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p.numpy()))
    best, path = _brute(pot[0], trans, 5)
    np.testing.assert_allclose(float(got_s.numpy()[0]), best, atol=TOL)
    assert tuple(got_p.numpy()[0]) == path
    lens = np.full(3, 5, np.int64)
    s2, p2 = tp.text.viterbi_decode(tp.to_tensor(pot), tp.to_tensor(trans),
                                    tp.to_tensor(lens))
    np.testing.assert_array_equal(p2.numpy(), got_p.numpy())
    dec = tp.text.ViterbiDecoder(tp.to_tensor(trans))
    s3, p3 = dec(tp.to_tensor(pot))
    np.testing.assert_array_equal(p3.numpy(), got_p.numpy())


def test_viterbi_honours_lengths():
    pot, trans = _potentials(1, b=4, t=6)
    lens = np.array([6, 3, 1, 4], np.int64)
    scores, paths = tp.text.viterbi_decode(tp.to_tensor(pot),
                                           tp.to_tensor(trans),
                                           tp.to_tensor(lens))
    for b, n in enumerate(lens):
        best, path = _brute(pot[b], trans, int(n))
        np.testing.assert_allclose(float(scores.numpy()[b]), best, atol=TOL)
        assert tuple(paths.numpy()[b][:n]) == path
        assert (paths.numpy()[b][n:] == 0).all()
    # the reference decodes every row to the full width whatever lengths say
    ref_s, _ = jp.text.viterbi_decode(jp.to_tensor(pot), jp.to_tensor(trans),
                                      jp.to_tensor(lens))
    full_s, _ = tp.text.viterbi_decode(tp.to_tensor(pot), tp.to_tensor(trans))
    np.testing.assert_allclose(np.asarray(ref_s.numpy()), full_s.numpy(),
                               atol=TOL)
    assert not np.allclose(scores.numpy()[1:3], full_s.numpy()[1:3])


@pytest.mark.parametrize("name,kw", [
    ("Imdb", {}), ("UCIHousing", {}), ("Conll05st", {}), ("Imikolov", {}),
    ("Movielens", {}), ("WMT14", {}), ("WMT16", {})])
def test_text_datasets_like_jax(name, kw):
    for mode in ("train", "test"):
        ours = getattr(tp.text, name)(mode=mode, **kw)
        theirs = getattr(jp.text, name)(mode=mode, **kw)
        assert len(ours) == len(theirs)
        for i in (0, len(ours) - 1):
            for a, b in zip(ours[i], theirs[i]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(tp.text.UCIHousing(mode="train")) == 404


def test_string_tensor_ops_like_jax():
    data = [["Hello", "WORLD"], ["Grüße", "ÅØ"]]
    for p in (tp, jp):
        st = p.strings.to_string_tensor(data)
        assert st.shape == [2, 2] and st.ndim == 2 and st.size == 4
    st = tp.strings.to_string_tensor(data)
    jst = jp.strings.to_string_tensor(data)
    for fn in ("lower", "upper"):
        for utf8 in (True, False):
            assert (getattr(tp.strings, fn)(st, utf8).tolist()
                    == getattr(jp.strings, fn)(jst, utf8).tolist())
    assert tp.strings.lower(st).tolist() == [["hello", "world"],
                                             ["grüße", "åø"]]
    assert tp.strings.upper(st).tolist() == [["HELLO", "WORLD"],
                                             ["GRÜSSE", "ÅØ"]]
    lo_a = tp.strings.lower(st, use_utf8_encoding=False)
    assert lo_a.tolist()[1][1] == "ÅØ" and lo_a.tolist()[0][0] == "hello"
    assert st[0, 1] == "WORLD" and st[1].tolist() == ["Grüße", "ÅØ"]
    assert st.reshape([4]).tolist() == ["Hello", "WORLD", "Grüße", "ÅØ"]
    assert (st == jst.numpy()).all()
    assert "StringTensor" in repr(st)


def test_strings_utf8_like_jax():
    words = ["abc", "Grüße", ""]
    codes, lens = tp.strings.encode_utf8(tp.strings.to_string_tensor(words))
    jcodes, jlens = jp.strings.encode_utf8(jp.strings.to_string_tensor(words))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes.numpy()))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens.numpy()))
    assert codes.shape[0] == 3 and codes.dtype == tp.uint8
    assert tp.strings.decode_utf8(codes, lens).tolist() == words
    # a cut inside a 2-byte code point backs off to "Gr"
    c3, l3 = tp.strings.encode_utf8(tp.strings.to_string_tensor(["Grüße"]),
                                    max_bytes=3)
    assert tp.strings.decode_utf8(c3, l3).tolist() == ["Gr"]
    # without lengths, the padding is stripped
    c, _ = tp.strings.encode_utf8(tp.strings.to_string_tensor(["a", "bbb"]))
    assert tp.strings.decode_utf8(c).tolist() == ["a", "bbb"]
    e = tp.strings.empty((2, 3))
    assert e.shape == [2, 3] and e[0, 0] == ""
    assert e.tolist() == jp.strings.empty((2, 3)).tolist()
