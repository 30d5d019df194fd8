"""The port's ``fft``, ``signal``, ``linalg`` namespace and ``audio``
against the JAX package on the CPU.

Both packages take the same seeded float32 numpy inputs. Transforms
agree within 1e-4 (an FFT's sums run in another order in each library),
element-wise and small linear algebra within 1e-5. The port's ``istft``
overlap-adds every frame in one ``fold``: it is held to the reference's
frame-by-frame loop within 1e-6 of the signal's peak, and to a fixed
number of dispatched ops whatever the frame count. The randomized
low-rank factorisations draw another test matrix than the reference's,
so they are held by their reconstruction of a matrix of that rank.
"""
import math

import numpy as np
import pytest
import scipy.linalg as sla
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as jp
import paddle_tpu.audio.features as jfeat
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
FFT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return np.asarray(t.numpy())


def _both(fn, *arrays, tol=TOL):
    got = fn(tp, *[tp.to_tensor(a) for a in arrays])
    want = fn(jp, *[jp.to_tensor(a) for a in arrays])
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)
    return got


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# -- fft ---------------------------------------------------------------------
FFT_1D = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft"]
FFT_ND = ["fft2", "ifft2", "rfft2", "irfft2", "fftn", "ifftn", "rfftn",
          "irfftn", "hfft2", "ihfft2", "hfftn", "ihfftn"]


@pytest.mark.parametrize("name", FFT_1D)
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_fft_1d_like_jax(name, norm):
    x = _x(3, 8)
    _both(lambda p, a: getattr(p.fft, name)(a, norm=norm), x, tol=FFT_TOL)
    _both(lambda p, a: getattr(p.fft, name)(a, n=6, axis=0), x, tol=FFT_TOL)


@pytest.mark.parametrize("name", FFT_ND)
def test_fft_nd_like_jax(name):
    x = _x(2, 6, 8, seed=1)
    _both(lambda p, a: getattr(p.fft, name)(a), x, tol=FFT_TOL)
    if name not in ("hfft2", "ihfft2"):
        _both(lambda p, a: getattr(p.fft, name)(a, s=[4, 6], axes=[0, 2]),
              x, tol=FFT_TOL)


def test_fft_of_complex_input_and_helpers_like_jax():
    x = (_x(4, 8) + 1j * _x(4, 8, seed=2)).astype(np.complex64)
    for name in ("fft", "ifft", "irfft", "hfft"):
        _both(lambda p, a: getattr(p.fft, name)(a), x, tol=FFT_TOL)
    _both(lambda p, a: p.fft.fftshift(a), _x(5, 6))
    _both(lambda p, a: p.fft.ifftshift(a, axes=[1]), _x(5, 6))
    for n, d in ((8, 1.0), (9, 0.5)):
        np.testing.assert_allclose(_np(tp.fft.fftfreq(n, d)),
                                   _np(jp.fft.fftfreq(n, d)), atol=TOL)
        np.testing.assert_allclose(_np(tp.fft.rfftfreq(n, d)),
                                   _np(jp.fft.rfftfreq(n, d)), atol=TOL)


@pytest.mark.parametrize("fn", ["fftshift", "ifftshift"])
@pytest.mark.parametrize("axes", [1, [1], (0, 1), -1])
def test_fftshift_takes_an_int_list_or_tuple_like_jax(fn, axes):
    _both(lambda p, a: getattr(p.fft, fn)(a, axes=axes), _x(3, 5))


def test_fft_takes_name_and_fftfreq_dtype_as_paddle():
    """Paddle's signatures where the reference departs from them: the
    transforms take ``name`` (the reference's raise on it) and ``fftfreq``/
    ``rfftfreq`` return ``dtype`` (the reference never reads it)."""
    x = _x(3, 8)
    np.testing.assert_allclose(
        _np(tp.fft.fft(tp.to_tensor(x), name="f")),
        _np(jp.fft.fft(jp.to_tensor(x))), atol=FFT_TOL)
    np.testing.assert_allclose(
        _np(tp.fft.fft2(tp.to_tensor(x), axes=1, name="f")),
        np.fft.fftn(x, axes=(1,)), atol=FFT_TOL, rtol=FFT_TOL)
    with pytest.raises(TypeError):
        jp.fft.fft(jp.to_tensor(x), name="f")
    for fn in ("fftfreq", "rfftfreq"):
        for dtype, want in ((None, np.float32), ("float64", np.float64),
                            ("float32", np.float32)):
            got = getattr(tp.fft, fn)(9, 0.5, dtype=dtype)
            assert _np(got).dtype == want
            np.testing.assert_allclose(
                _np(got), _np(getattr(jp.fft, fn)(9, 0.5)), atol=TOL)


def test_fft_hermitian_variants():
    x = _x(8, 8)
    out = tp.fft.ihfft2(tp.to_tensor(x))
    np.testing.assert_allclose(_np(out), np.conj(np.fft.rfft2(
        x, norm="forward")), atol=FFT_TOL)
    np.testing.assert_allclose(_np(tp.fft.hfft2(out)), x, atol=FFT_TOL)


def test_fft_abs_gradient_like_jax():
    x = _x(8)
    res = {}
    for p in (jp, tp):
        t = p.to_tensor(x)
        t.stop_gradient = False
        p.fft.rfft(t).abs().sum().backward()
        res[p] = _np(t.grad)
    np.testing.assert_allclose(res[tp], res[jp], atol=FFT_TOL)


# -- signal -------------------------------------------------------------------
@pytest.mark.parametrize("axis", [-1, 0])
def test_frame_and_overlap_add_like_jax(axis):
    x = _x(37, 3) if axis == 0 else _x(2, 37)
    f = _both(lambda p, a: p.signal.frame(a, 8, 3, axis=axis), x)[0]
    _both(lambda p, a: p.signal.overlap_add(a, 3, axis=axis), f.numpy())
    f10 = tp.signal.frame(tp.to_tensor(np.arange(10, dtype=np.float32)), 4, 2,
                          axis=0)
    assert f10.shape == [4, 4]
    np.testing.assert_allclose(_np(f10)[0], [0, 1, 2, 3])
    assert tp.signal.overlap_add(f10, 2, axis=0).shape == [10]


STFT_CASES = [
    dict(n_fft=128),
    dict(n_fft=64, hop_length=16, win_length=48, window="hann"),
    dict(n_fft=64, center=False, window="hann"),
    dict(n_fft=32, normalized=True, window="hann"),
    dict(n_fft=32, onesided=False, window="hann"),
    dict(n_fft=32, pad_mode="constant", window="hann"),
]


@pytest.mark.parametrize("kw", STFT_CASES, ids=lambda k: "-".join(
    f"{a}{b}" for a, b in k.items()))
def test_stft_istft_like_jax(kw):
    kw = dict(kw)
    win = kw.pop("window", None)
    wl = kw.get("win_length") or kw["n_fft"]
    w = (None if win is None else
         np.hanning(wl + 1)[:-1].astype(np.float32))
    x = _x(2, 1000)

    def stft(p, a, *wt):
        return p.signal.stft(a, window=wt[0] if wt else None, **kw)

    args = (x,) if w is None else (x, w)
    spec = _both(stft, *args, tol=FFT_TOL)[0]
    if kw.get("pad_mode") == "constant" or not kw.get("center", True):
        return
    ikw = {k: v for k, v in kw.items() if k != "pad_mode"}

    def istft(p, s, *wt):
        return p.signal.istft(s, window=wt[0] if wt else None, length=1000,
                              **ikw)

    sargs = (spec.numpy(),) if w is None else (spec.numpy(), w)
    y = _np(_both(istft, *sargs, tol=FFT_TOL)[0])
    # the last frame may end before the signal does (both packages)
    np.testing.assert_allclose(y, x[:, :y.shape[-1]], atol=1e-4)
    assert y.shape[-1] > 1000 - kw["n_fft"]


def _istft_loop(spec, n_fft, hop, w):
    """The reference's frame-by-frame overlap-add, in torch."""
    t = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * w
    n = t.shape[-2]
    out = torch.zeros(t.shape[:-2] + ((n - 1) * hop + n_fft,))
    wsum = torch.zeros((n - 1) * hop + n_fft)
    for i in range(n):
        out[..., i * hop:i * hop + n_fft] += t[..., i, :]
        wsum[i * hop:i * hop + n_fft] += w * w
    out = out / wsum.clamp_min(1e-10)
    return out[..., n_fft // 2:out.shape[-1] - n_fft // 2]


def test_istft_is_one_pass_and_matches_the_loop():
    n_fft, hop = 400, 160
    w = torch.hann_window(n_fft)
    counts = []
    for samples in (4000, 16000):
        x = _x(3, samples, seed=3)
        spec = tp.signal.stft(tp.to_tensor(x), n_fft, hop,
                              window=tp.to_tensor(w))
        with _Ops() as ops:
            y = tp.signal.istft(spec, n_fft, hop, window=tp.to_tensor(w))
        counts.append(ops.n)
        want = _istft_loop(spec._data, n_fft, hop, w).numpy()
        peak = np.abs(want).max()
        np.testing.assert_allclose(_np(y), want, atol=1e-6 * peak)
    assert counts[0] == counts[1] and counts[0] < 50, counts


# -- linalg -------------------------------------------------------------------
def _spd(n, seed=0):
    a = _x(n, n, seed=seed)
    return a @ a.T + n * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("upper", [False, True])
def test_cholesky_inverse_like_jax(upper):
    spd = _spd(4)
    fac = np.linalg.cholesky(spd)
    fac = fac.T.copy() if upper else fac
    got = _both(lambda p, a: p.linalg.cholesky_inverse(a, upper=upper), fac,
                tol=1e-4)[0]
    np.testing.assert_allclose(_np(got), np.linalg.inv(spd), atol=1e-4)


@pytest.mark.parametrize("p_", [None, 2, "fro", "nuc", 1, -1, np.inf, -2])
def test_cond_like_jax(p_):
    _both(lambda p, a: p.linalg.cond(a, p_), _spd(4, 1) + _x(4, 4, seed=2),
          tol=1e-4)


def test_linalg_tail_like_jax():
    a = _x(4, 4)
    b3 = _x(2, 3, 4, seed=1)
    _both(lambda p, x: p.linalg.svdvals(x), a, tol=1e-4)
    _both(lambda p, x, y: p.linalg.cross(x, y), _x(3, 5), _x(3, 5, seed=4))
    _both(lambda p, x, y: p.linalg.cross(x, y, axis=0), _x(3, 3),
          _x(3, 3, seed=5))
    _both(lambda p, x: p.linalg.matrix_exp(x), 0.3 * a, tol=1e-4)
    _both(lambda p, x, y: p.linalg.vecdot(x, y), b3, _x(2, 3, 4, seed=6))
    _both(lambda p, x: p.linalg.matrix_transpose(x), b3)
    _both(lambda p, x: p.matrix_transpose(x), b3)
    _both(lambda p, x: p.linalg.diagonal(x, 1), b3)
    _both(lambda p, x: p.linalg.diagonal(x, 0, 0, 2), b3)
    for name in ("cholesky", "det", "inv", "norm", "pinv", "qr", "svd",
                 "slogdet", "eigh", "matrix_rank"):
        assert hasattr(tp.linalg, name), name
    np.testing.assert_allclose(_np(tp.linalg.matrix_exp(tp.to_tensor(
        np.zeros((3, 3), np.float32)))), np.eye(3), atol=1e-6)


def test_low_rank_factorisations_reconstruct():
    rng = np.random.RandomState(7)
    a = (rng.randn(30, 4) @ rng.randn(4, 20)).astype(np.float32)
    for q in (4, 6):
        u, s, v = tp.linalg.svd_lowrank(tp.to_tensor(a), q=q)
        rec = _np(u) @ np.diag(_np(s)) @ _np(v).T
        np.testing.assert_allclose(rec, a, atol=1e-3)
        ju, js, jv = jp.linalg.svd_lowrank(jp.to_tensor(a), q=q)
        np.testing.assert_allclose(_np(s)[:4], _np(js)[:4], rtol=1e-4)
    m = np.tile(a.mean(0, keepdims=True), (30, 1))
    u, s, v = tp.linalg.svd_lowrank(tp.to_tensor(a), q=5,
                                    M=tp.to_tensor(m))
    np.testing.assert_allclose(_np(u) @ np.diag(_np(s)) @ _np(v).T, a - m,
                               atol=1e-3)
    u, s, v = tp.linalg.pca_lowrank(tp.to_tensor(a), q=5)
    np.testing.assert_allclose(_np(u) @ np.diag(_np(s)) @ _np(v).T, a - m,
                               atol=1e-3)
    _, js, _ = jp.linalg.pca_lowrank(jp.to_tensor(a), q=5)
    np.testing.assert_allclose(_np(s)[:4], _np(js)[:4], rtol=1e-4)


def test_lu_unpack_and_ormqr_like_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(4, 4).astype(np.float32)
    lu, piv = sla.lu_factor(a)
    got = _both(lambda p, x, y: p.linalg.lu_unpack(x, y), lu.astype(
        np.float32), (piv + 1).astype(np.int32))
    rec = _np(got[0]) @ _np(got[1]) @ _np(got[2])
    np.testing.assert_allclose(rec, a, atol=1e-4)
    ab = rng.randn(2, 3, 3).astype(np.float32)
    lus, pivs = zip(*[sla.lu_factor(ab[i]) for i in range(2)])
    _both(lambda p, x, y: p.linalg.lu_unpack(x, y),
          np.stack(lus).astype(np.float32),
          np.stack([pv + 1 for pv in pivs]).astype(np.int32))
    (h, tau), _ = sla.qr(a, mode="raw")
    h, tau = np.asarray(h, np.float32), np.asarray(tau, np.float32)
    for left, trans, y in ((True, False, rng.randn(4, 2)),
                           (True, True, rng.randn(4, 3)),
                           (False, False, rng.randn(2, 4))):
        _both(lambda p, x, t, o: p.linalg.ormqr(x, t, o, left, trans), h, tau,
              y.astype(np.float32), tol=1e-4)
    out = tp.linalg.ormqr(tp.to_tensor(h), tp.to_tensor(tau),
                          tp.to_tensor(np.eye(4, dtype=np.float32)))
    np.testing.assert_allclose(_np(out), sla.qr(a)[0], atol=1e-4)


def test_fp8_gemm_like_jax_on_exact_codes():
    """Small integers are e4m3 codes, so both libraries multiply them
    exactly; the result's rounding to float16 is the only step."""
    rng = np.random.RandomState(1)
    x = rng.randint(-4, 5, (3, 5, 16)).astype(np.float32)
    y = rng.randint(-4, 5, (16, 8)).astype(np.float32)
    bias = rng.randint(-2, 3, 8).astype(np.float32)
    _both(lambda p, a, b, c: p.linalg.fp8_fp8_half_gemm_fused(
        a, b, c, scale=0.5).astype("float32"), x, y, bias)
    _both(lambda p, a, b: p.linalg.fp8_fp8_half_gemm_fused(
        a, b, transpose_y=True, output_dtype="bfloat16").astype("float32"),
        x[0], y.T.copy())


# -- audio --------------------------------------------------------------------
def test_audio_functional_like_jax():
    AF, JF = tp.audio.functional, jp.audio.functional
    for win in ("hann", "hamming", "blackman", "rect"):
        for fftbins in (True, False):
            np.testing.assert_allclose(_np(AF.get_window(win, 16, fftbins)),
                                       _np(JF.get_window(win, 16, fftbins)))
    for kw in (dict(sr=16000, n_fft=512, n_mels=40),
               dict(sr=22050, n_fft=400, n_mels=80, f_min=50.0, htk=True,
                    norm=None)):
        fb = AF.compute_fbank_matrix(**kw)
        np.testing.assert_allclose(_np(fb), _np(JF.compute_fbank_matrix(
            **kw)), atol=1e-7)
    np.testing.assert_allclose(_np(AF.create_dct(13, 40)),
                               _np(JF.create_dct(13, 40)), atol=1e-7)
    for htk in (False, True):
        f = np.array([0.0, 440.0, 1000.0, 4000.0])
        np.testing.assert_allclose(AF.hz_to_mel(f, htk), JF.hz_to_mel(f, htk))
        np.testing.assert_allclose(AF.mel_to_hz(AF.hz_to_mel(f, htk), htk), f,
                                   rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(_np(AF.fft_frequencies(16000, 512)),
                               _np(JF.fft_frequencies(16000, 512)))
    np.testing.assert_allclose(_np(AF.mel_frequencies(40, 0.0, 8000.0)),
                               _np(JF.mel_frequencies(40, 0.0, 8000.0)),
                               rtol=1e-6)
    s = np.abs(_x(10, 10)) * 1e3
    for top_db in (None, 20.0, 80.0):
        _both(lambda p, a: p.audio.functional.power_to_db(
            a, ref_value=2.0, top_db=top_db), s, tol=1e-4)


@pytest.mark.parametrize("name,kw", [
    ("Spectrogram", dict(n_fft=128, hop_length=32)),
    ("Spectrogram", dict(n_fft=64, win_length=48, power=1.0)),
    ("MelSpectrogram", dict(sr=16000, n_fft=400, hop_length=160,
                            n_mels=20)),
    ("LogMelSpectrogram", dict(sr=16000, n_fft=400, hop_length=160,
                               n_mels=20, f_min=0.0, top_db=80.0)),
    ("MFCC", dict(sr=16000, n_mfcc=13, n_fft=400, hop_length=160,
                  n_mels=20, f_min=0.0)),
])
def test_feature_layers_like_jax(name, kw):
    x = _x(2, 4000, seed=8)
    got = getattr(tp.audio.features, name)(**kw)(tp.to_tensor(x))
    want = getattr(jfeat, name)(**kw)(jp.to_tensor(x))
    w = _np(want)
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(_np(got), w, atol=1e-4 * scale, rtol=1e-4)


def test_audio_wav_roundtrip_and_datasets(tmp_path):
    sr = 16000
    wav = tp.to_tensor(np.sin(np.linspace(0, 100, sr)).astype(
        np.float32)[None, :])
    path = str(tmp_path / "t.wav")
    tp.audio.save(path, wav, sr)
    meta = tp.audio.info(path)
    assert meta.sample_rate == sr and meta.num_samples == sr
    back, sr2 = tp.audio.load(path)
    assert sr2 == sr
    np.testing.assert_allclose(_np(back), _np(wav), atol=1e-3)
    ref, _ = jp.audio.load(path)
    np.testing.assert_array_equal(_np(back), _np(ref))
    assert tp.audio.backends.list_available_backends() == ["wave"]
    for name in ("TESS", "ESC50"):
        for mode in ("train", "dev"):
            ours = getattr(tp.audio.datasets, name)(mode=mode)
            theirs = getattr(jp.audio.datasets, name)(mode=mode)
            assert len(ours) == len(theirs)
            for i in (0, len(ours) - 1):
                np.testing.assert_array_equal(ours[i][0], theirs[i][0])
                assert ours[i][1] == theirs[i][1]
    assert math.isfinite(float(tp.audio.functional.power_to_db(
        tp.to_tensor(np.abs(_x(10, 10)))).numpy().max()))
