"""``paddle.vision`` of the port against the JAX package on the CPU: the
models, ``_load_pretrained``, the detection ops, the transforms and
``FakeData``.

Every model is built in both packages with the same ``state_dict`` names,
in order, and shapes, and gets the same seeded numpy weights
(``convert.layer_state_from_numpy`` on the port's side; the JAX side's
initializers are zeros from numpy while it is built, since its random
ones compile for every shape). The JAX side runs under one
``jax.jit`` of ``jit.functional_call`` (with ``jax.value_and_grad`` for
the training step): the same functionals as its eager path, one compile
a model.

- ``resnet18`` and ``resnet50`` at 2 x 3 x 64 x 64 with 4 classes, train
  mode: logits and loss to 1e-4 (relative), each gradient to 5e-4 of its
  leaf's norm, and the batch norms' running statistics after the step to
  1e-5. The last batch norm of each residual branch starts at a fifth of
  its seeded gain (as nets are initialised to train well), and the input
  is 64 x 64: at 32 x 32 the last stage is 1 x 1, a batch of 2 leaves
  its batch norms two values a channel, and f32 rounding then swings the
  result by percents. That is the step's conditioning, not a fault of
  either package: the port in f32 parts from the port in f64 by as much
  as from the JAX package in f32, and in f64 the two packages agree at
  every size, undamped too (``tests/test_torch_vision_f64.py``;
  ``python tests/torch_resnet_conditioning.py`` prints the gaps);
- one eval-mode forward of each other family at the smallest input it
  takes, the output to 1e-4 of its largest entry;
- the detection ops and transforms against the reference's on the same
  arrays (the random transforms from the same ``np.random`` seed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit import functional_call
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy
from test_torch_conv_pool import fast_jax_init, seeded  # noqa: F401

LOGIT_RTOL = 1e-4
GRAD_RTOL = 5e-4          # of each leaf's norm
STAT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(name, **kw):
    jm = getattr(jp.vision.models, name)(**kw)
    tm = getattr(tp.vision.models, name)(**kw)
    state = seeded(jm, tm)
    return jm, tm, state


def _jax_state(jm, state):
    return {k: jnp.asarray(v) for k, v in state.items()}


# -- ResNets, one training step ---------------------------------------------
def resnet_step(name, image, damp, dtype="float32"):
    """One train-mode step of ``name`` (4 classes) at 2 x 3 x ``image`` x
    ``image`` in ``dtype`` in both packages on the same seeded weights,
    with the last batch norm of each residual branch at a fifth of its
    gain when ``damp``. Returns numpy pairs (port, JAX): ``"logits"``,
    ``"loss"``, ``"grads"`` by parameter name and ``"stats"`` (the running
    statistics after the step) by buffer name, and ``"start"``, the
    seeded state. A float64 run needs JAX's x64."""
    jm, tm, state = _pair(name, num_classes=4)
    last_bn = "bn3.weight" if name == "resnet50" else "bn2.weight"
    if damp:
        for k in state:
            if k.startswith("layer") and k.endswith(last_bn):
                state[k] = state[k] * np.float32(0.2)
    jm.set_state_dict(state)
    layer_state_from_numpy(state, tm)
    x = _x(2, 3, image, image, seed=1).astype(dtype)
    y = np.array([1, 3], np.int64)
    names = [n for n, _ in jm.named_parameters()]
    jm.train()

    def loss_fn(params, bufs, a):
        out, mutated = functional_call(jm, dict(bufs, **params), a)
        loss = jp.nn.functional.cross_entropy(
            jp.Tensor(out), jp.Tensor(jnp.asarray(y)))._data
        return loss, (out, mutated)

    js = {k: jnp.asarray(v.astype(dtype)) for k, v in state.items()}
    params = {n: js[n] for n in names}
    bufs = {k: v for k, v in js.items() if k not in params}
    (jloss, (jout, jmut)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, bufs, jnp.asarray(x))
    assert jout.dtype == np.dtype(dtype)

    tm.to(dtype=dtype)
    tm.train()
    out = tm(tp.to_tensor(x, dtype=dtype))
    assert out.numpy().dtype == np.dtype(dtype)
    loss = tp.nn.functional.cross_entropy(out, tp.to_tensor(y))
    loss.backward()
    grads = dict(tm.named_parameters())
    assert set(grads) == set(names)
    return {
        "logits": (out.numpy(), np.asarray(jout)),
        "loss": (float(loss), float(jloss)),
        "grads": {n: (grads[n].grad.numpy(), np.asarray(jgrads[n]))
                  for n in names},
        "stats": {k: (b.numpy(), np.asarray(jmut[k]))
                  for k, b in tm.state_dict().items()
                  if k.endswith(("_mean", "_variance"))},
        "start": state,
    }


def grad_err(got, want):
    """``|got - want|`` over ``|want|`` (Frobenius, in float64)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def assert_resnet_step_like_jax(r):
    """:func:`resnet_step`'s two sides within the bounds above."""
    np.testing.assert_allclose(*r["logits"], rtol=LOGIT_RTOL,
                               atol=LOGIT_RTOL)
    np.testing.assert_allclose(*r["loss"], rtol=LOGIT_RTOL)
    for n, (got, want) in r["grads"].items():
        assert grad_err(got, want) <= GRAD_RTOL, (n, grad_err(got, want))
    stats = r["stats"]
    assert len(stats) == 2 * sum(1 for k in stats if k.endswith("_mean"))
    for k, (got, want) in stats.items():
        assert not np.allclose(got, r["start"][k]), k  # the step moved it
        np.testing.assert_allclose(got, want, atol=STAT_TOL, rtol=STAT_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_train_step_like_jax(name, fast_jax_init):
    assert_resnet_step_like_jax(resnet_step(name, 64, damp=True))


# -- the other families, one eval forward -----------------------------------
FAMILIES = [
    ("vgg11", dict(batch_norm=True, num_classes=0), (2, 3, 32, 32)),
    ("alexnet", dict(num_classes=4), (2, 3, 64, 64)),
    ("mobilenet_v1", dict(num_classes=4, scale=0.5), (2, 3, 32, 32)),
    ("mobilenet_v2", dict(num_classes=4, scale=0.5), (2, 3, 32, 32)),
    ("mobilenet_v3_small", dict(num_classes=4), (2, 3, 32, 32)),
    ("mobilenet_v3_large", dict(num_classes=4, scale=0.5), (2, 3, 32, 32)),
    ("densenet121", dict(num_classes=4), (2, 3, 32, 32)),
    ("squeezenet1_1", dict(num_classes=4), (2, 3, 32, 32)),
    ("inception_v3", dict(num_classes=4), (2, 3, 75, 75)),
    ("shufflenet_v2_x0_25", dict(num_classes=4), (2, 3, 32, 32)),
    ("googlenet", dict(num_classes=4), (2, 3, 32, 32)),
    ("resnext50_32x4d", dict(num_classes=4), (2, 3, 32, 32)),
]


@pytest.mark.parametrize("name,kw,shape", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_eval_forward_like_jax(name, kw, shape, fast_jax_init):
    jm, tm, state = _pair(name, **kw)
    x = _x(*shape, seed=2)
    jm.eval()
    tm.eval()

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    want = np.asarray(jax.jit(lambda s, a: first(functional_call(
        jm, s, a)[0]))(_jax_state(jm, state), jnp.asarray(x)))
    got = first(tm(tp.to_tensor(x))).numpy()
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    tol = LOGIT_RTOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=LOGIT_RTOL)


def test_lenet_and_googlenet_outputs():
    tp.seed(0)
    out = tp.vision.models.LeNet()(tp.randn([2, 1, 28, 28]))
    assert out.shape == [2, 10]
    main, aux1, aux2 = tp.vision.models.googlenet(num_classes=3)(
        tp.randn([1, 3, 32, 32]))
    assert main.shape == [1, 3] and aux1 is None and aux2 is None


# -- pretrained ----------------------------------------------------------------
def test_load_pretrained_branches(tmp_path):
    tp.seed(0)
    m = tp.vision.models.resnet18(num_classes=3)
    path = str(tmp_path / "r18.pdparams")
    tp.save(m.state_dict(), path)
    tp.seed(1)
    fresh = tp.vision.models.resnet18(num_classes=3)
    assert not np.array_equal(fresh.fc.weight.numpy(), m.fc.weight.numpy())
    loaded = tp.vision.models.resnet18(pretrained=path, num_classes=3)
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              loaded.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    with pytest.raises(RuntimeError, match="no weights are registered"):
        tp.vision.models.resnet18(pretrained=True)
    with pytest.raises(NotImplementedError, match="network"):
        tp.vision.models.resnet18(pretrained="https://example.invalid/w")
    with pytest.raises(NotImplementedError, match="network"):
        tp.vision.models.resnet18(pretrained=str(tmp_path / "absent"))


# -- detection ops -----------------------------------------------------------------
def _listed(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _both(fn, *arrays, jit=False):
    """``fn(package, *tensors)`` in both packages; numpy outputs. ``jit``
    runs the JAX side under one ``jax.jit`` (its ops trace; those that
    run on the host in numpy do not)."""
    if jit:
        def f(*xs):
            return [o._data for o in _listed(fn(jp, *map(JTensor, xs)))]

        want = [np.asarray(o) for o in jax.jit(f)(
            *[jnp.asarray(a) for a in arrays])]
    else:
        want = [np.asarray(o.numpy()) for o in _listed(
            fn(jp, *[jp.to_tensor(a) for a in arrays]))]
    got = [o.numpy() for o in _listed(fn(tp, *[tp.to_tensor(a)
                                                for a in arrays]))]
    return want, got


BOXES = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60],
                  [2, 0, 12, 9], [49, 52, 58, 61]], np.float32)
SCORES = np.array([0.9, 0.8, 0.7, 0.85, 0.6], np.float32)


def test_nms_and_box_iou():
    boxes = tp.to_tensor(BOXES[:3])
    scores = tp.to_tensor(SCORES[:3])
    kept = tp.vision.ops.nms(boxes, 0.5, scores).numpy()
    assert list(kept) == [0, 2]
    iou = tp.vision.ops.box_iou(boxes, boxes).numpy()
    np.testing.assert_allclose(np.diag(iou), 1.0, atol=1e-6)
    for thr in (0.1, 0.3, 0.5):
        (want,), (got,) = _both(lambda p, b, s: p.vision.ops.nms(b, thr, s),
                                BOXES, SCORES)
        np.testing.assert_array_equal(got, want)
    (want,), (got,) = _both(lambda p, b: p.vision.ops.nms(b, 0.3), BOXES)
    np.testing.assert_array_equal(got, want)
    for op in ("box_iou", "box_area"):
        (want,), (got,) = _both(
            lambda p, b: getattr(p.vision.ops, op)(
                *((b, b) if op == "box_iou" else (b,))), BOXES)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_nms_per_category():
    boxes = tp.to_tensor(BOXES[:2])
    scores = tp.to_tensor(SCORES[:2])
    kept = tp.vision.ops.nms(boxes, 0.5, scores,
                             category_idxs=tp.to_tensor(np.array([0, 1])),
                             categories=[0, 1]).numpy()
    assert sorted(kept.tolist()) == [0, 1]
    kept2 = tp.vision.ops.nms(boxes, 0.5, scores,
                              category_idxs=tp.to_tensor(np.array([0, 0])),
                              categories=[0]).numpy()
    assert kept2.tolist() == [0]
    cats = np.array([0, 1, 0, 0, 1], np.int64)
    (want,), (got,) = _both(lambda p, b, s, c: p.vision.ops.nms(
        b, 0.3, s, category_idxs=c, top_k=3), BOXES, SCORES, cats)
    np.testing.assert_array_equal(got, want)


ROIS = np.array([[2.0, 2, 10, 10], [0.5, 1.5, 7.25, 12.5],
                 [3, 4, 14, 9]], np.float32)


@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_like_jax(aligned):
    x = tp.ones([1, 2, 16, 16]) * 7.0
    out = tp.vision.ops.roi_align(x, tp.to_tensor(ROIS[:1]),
                                  tp.to_tensor(np.array([1], np.int32)), 4)
    np.testing.assert_allclose(out.numpy(), 7.0, atol=1e-5)
    feat = _x(2, 3, 16, 16, seed=3)
    num = np.array([2, 1], np.int32)
    (want,), (got,) = _both(lambda p, f, r, n: p.vision.ops.roi_align(
        f, r, n, (3, 2), spatial_scale=0.5, sampling_ratio=2,
        aligned=aligned), feat, ROIS, num, jit=True)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_roi_pool_psroi_pool_like_jax():
    feat = _x(2, 8, 16, 16, seed=4)
    num = np.array([1, 2], np.int32)
    (want,), (got,) = _both(lambda p, f, r, n: p.vision.ops.roi_pool(
        f, r, n, 3, spatial_scale=0.75), feat, ROIS, num, jit=True)
    np.testing.assert_array_equal(got, want)
    (want,), (got,) = _both(lambda p, f, r, n: p.vision.ops.psroi_pool(
        f, r, n, 2), feat, ROIS, num, jit=True)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_deform_conv2d():
    x = _x(1, 3, 8, 8, seed=5)
    w = _x(5, 3, 3, 3, seed=6)
    out = tp.vision.ops.deform_conv2d(tp.to_tensor(x), tp.zeros([1, 18, 8, 8]),
                                      tp.to_tensor(w), padding=1)
    ref = tp.nn.functional.conv2d(tp.to_tensor(x), tp.to_tensor(w), padding=1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4,
                               rtol=1e-4)
    off = _x(1, 18, 4, 4, seed=7)
    mask = 1 / (1 + np.exp(-_x(1, 9, 4, 4, seed=8)))
    bias = _x(5, seed=9)
    (want,), (got,) = _both(lambda p, a, o, k, b, m: p.vision.ops.
                            deform_conv2d(a, o, k, b, stride=2, padding=1,
                                          mask=m), x, off, w, bias, mask,
                            jit=True)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_yolo_box_box_coder_prior_box_like_jax():
    feat = _x(2, 2 * (5 + 3), 4, 4, seed=10)
    sizes = np.array([[64, 80], [96, 64]], np.int32)
    want, got = _both(lambda p, f, s: p.vision.ops.yolo_box(
        f, s, [10, 13, 16, 30], 3, 0.4, downsample_ratio=16), feat, sizes,
        jit=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5)
    priors = np.array([[0.1, 0.1, 0.4, 0.5], [0.3, 0.2, 0.9, 0.7]],
                      np.float32)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    targets = np.array([[0.2, 0.1, 0.5, 0.6], [0.0, 0.3, 0.7, 0.9],
                        [0.4, 0.4, 0.6, 0.8]], np.float32)
    (want,), (got,) = _both(lambda p, pb, pv, t: p.vision.ops.box_coder(
        pb, pv, t), priors, var, targets, jit=True)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    deltas = _x(2, 3, 4, seed=11) * 0.1
    (want,), (got,) = _both(lambda p, pb, pv, t: p.vision.ops.box_coder(
        pb, pv, t, code_type="decode_center_size"), priors, var, deltas,
        jit=True)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    want, got = _both(lambda p, f, im: p.vision.ops.prior_box(
        f, im, [4.0, 8.0], [6.0, 12.0], [2.0], flip=True, clip=True),
        _x(1, 2, 3, 4, seed=12), _x(1, 3, 24, 32, seed=13))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)


def test_matrix_nms_and_fpn_like_jax():
    rng = np.random.RandomState(14)
    xy = rng.rand(1, 6, 2).astype(np.float32) * 0.5
    boxes = np.concatenate([xy, xy + 0.3], -1)
    scores = rng.rand(1, 3, 6).astype(np.float32)
    want, got = _both(lambda p, b, s: p.vision.ops.matrix_nms(
        b, s, 0.1, post_threshold=0.05, return_index=True), boxes, scores)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)
    rois = np.array([[0, 0, 20, 20], [0, 0, 200, 200], [5, 5, 60, 90],
                     [0, 0, 600, 500]], np.float32)
    for p in (jp, tp):
        outs, nums, restore = p.vision.ops.distribute_fpn_proposals(
            p.to_tensor(rois), 2, 5, 4, 224)
        if p is jp:
            want = ([np.asarray(o.numpy()) for o in outs],
                    [int(np.asarray(n.numpy())[0]) for n in nums],
                    np.asarray(restore.numpy()))
    got = ([o.numpy() for o in outs], [int(n.numpy()[0]) for n in nums],
           restore.numpy())
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    for fn in (tp.vision.ops.yolo_loss, tp.vision.ops.generate_proposals):
        with pytest.raises(NotImplementedError):
            fn()


def test_deform_conv_and_roi_layers():
    tp.seed(0)
    layer = tp.vision.ops.DeformConv2D(3, 4, 3, padding=1)
    out = layer(tp.randn([1, 3, 6, 6]), tp.zeros([1, 18, 6, 6]))
    assert out.shape == [1, 4, 6, 6]
    feat = tp.randn([1, 8, 8, 8])
    boxes = tp.to_tensor(ROIS[:2])
    num = tp.to_tensor(np.array([2], np.int32))
    assert tp.vision.ops.RoIAlign(2)(feat, boxes, num).shape == [2, 8, 2, 2]
    assert tp.vision.ops.RoIPool(2)(feat, boxes, num).shape == [2, 8, 2, 2]
    assert tp.vision.ops.PSRoIPool(2)(feat, boxes, num).shape == [2, 2, 2, 2]


# -- transforms and datasets -----------------------------------------------------
def test_transforms_functional():
    import paddle_tpu.vision.transforms as JT

    T = tp.vision.transforms
    img = (np.random.RandomState(0).rand(12, 16, 3) * 255).astype(np.uint8)
    assert T.vflip(img).shape == img.shape
    np.testing.assert_array_equal(T.vflip(T.vflip(img)), img)
    assert T.center_crop(img, 8).shape == (8, 8, 3)
    assert T.pad(img, 2).shape == (16, 20, 3)
    assert T.to_grayscale(img, 3).shape == img.shape
    assert T.adjust_brightness(img, 0.5).mean() < img.mean()
    sq = (np.random.RandomState(1).rand(16, 16, 3) * 255).astype(np.uint8)
    rot = T.rotate(sq, 90)
    interior = np.abs(rot[1:-1, 1:-1].astype(int)
                      - np.rot90(sq)[1:-1, 1:-1].astype(int))
    assert interior.mean() < 1.0
    for fn, args in (("vflip", ()), ("hflip", ()), ("center_crop", (8,)),
                     ("pad", ([1, 2, 3, 4], 7, "reflect")),
                     ("crop", (1, 2, 5, 6)), ("adjust_brightness", (1.3,)),
                     ("adjust_contrast", (0.6,)), ("adjust_hue", (0.2,)),
                     ("adjust_saturation", (0.4,)), ("to_grayscale", (1,)),
                     ("rotate", (30,)), ("rotate", (17, "bilinear", True)),
                     ("affine", (10, (2, 1), 1.1, (5.0, 0.0))),
                     ("perspective", ([(0, 0), (15, 0), (15, 11), (0, 11)],
                                      [(1, 2), (14, 0), (13, 11), (2, 10)])),
                     ("erase", (1, 2, 3, 4, 0))):
        np.testing.assert_array_equal(getattr(T, fn)(img, *args),
                                      getattr(JT, fn)(img, *args),
                                      err_msg=fn)
    chw = np.random.RandomState(2).rand(3, 10, 12).astype(np.float32)
    for t_name, args in (("Normalize", ([0.4, 0.5, 0.6], [0.2, 0.3, 0.4])),
                         ("Resize", ((6, 5),)), ("CenterCrop", (6,)),
                         ("Transpose", ((1, 2, 0),)), ("ToTensor", ())):
        np.testing.assert_allclose(getattr(T, t_name)(*args)(chw),
                                   getattr(JT, t_name)(*args)(chw),
                                   err_msg=t_name)


def test_transform_classes_like_jax():
    import paddle_tpu.vision.transforms as JT

    T = tp.vision.transforms
    img = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
    for name, args in (("RandomResizedCrop", (16,)),
                       ("ColorJitter", (0.4, 0.4, 0.4, 0.1)),
                       ("Pad", (2,)), ("RandomRotation", (15,)),
                       ("RandomAffine", (10,)),
                       ("RandomPerspective", (1.0,)), ("Grayscale", (3,)),
                       ("RandomErasing", (1.0,)),
                       ("RandomHorizontalFlip", (1.0,)),
                       ("RandomVerticalFlip", (1.0,)), ("RandomCrop", (20, 2))):
        outs = []
        for mod in (JT, T):
            np.random.seed(0)
            outs.append(getattr(mod, name)(*args)(img))
        assert outs[1] is not None and outs[1].ndim == 3, name
        np.testing.assert_array_equal(outs[1], outs[0], err_msg=name)
    np.random.seed(0)
    composed = T.Compose([T.RandomCrop(24), T.ToTensor(),
                          T.Normalize([0.5] * 3, [0.5] * 3)])(img)
    assert composed.shape == (3, 24, 24)


def test_rotate_expand_and_nearest():
    T = tp.vision.transforms
    img = np.full((10, 20), 3, np.uint8)
    out = T.rotate(img, 90, expand=True)
    assert abs(out.shape[0] - 20) <= 1 and abs(out.shape[1] - 10) <= 1
    lab = np.random.RandomState(0).randint(0, 5, (16, 16)).astype(np.uint8)
    rot = T.rotate(lab, 30, interpolation="nearest")
    assert set(np.unique(rot)).issubset(set(np.unique(lab)) | {0})


def test_datasets_like_jax(tmp_path):
    jd = jp.vision.datasets.FakeData(size=4, image_shape=(3, 8, 8),
                                     num_classes=5)
    td = tp.vision.datasets.FakeData(size=4, image_shape=(3, 8, 8),
                                     num_classes=5)
    for i in range(4):
        for a, b in zip(jd[i], td[i]):
            np.testing.assert_array_equal(a, b)
    m = tp.vision.datasets.MNIST(mode="test")
    img, label = m[3]
    assert img.shape == (1, 28, 28) and label.dtype == np.int64
    assert len(tp.vision.datasets.Cifar10()) == 1024
    assert len(tp.vision.datasets.Flowers()) == 128
    assert len(tp.vision.datasets.VOC2012()) == 64
    for c in ("a", "b"):
        (tmp_path / c).mkdir()
        np.save(tmp_path / c / "0.npy", np.zeros((2, 2), np.float32))
    folder = tp.vision.datasets.DatasetFolder(str(tmp_path))
    assert len(folder) == 2 and int(folder[1][1]) == 1
    with pytest.raises(FileNotFoundError):
        tp.vision.datasets.DatasetFolder(str(tmp_path / "absent"))


def test_image_backend_and_load(tmp_path):
    V = tp.vision
    assert V.get_image_backend() == "pil"
    with pytest.raises(ValueError):
        V.set_image_backend("other")
    V.set_image_backend("tensor")
    try:
        assert V.get_image_backend() == "tensor"
    finally:
        V.set_image_backend("pil")
    with pytest.raises(ImportError, match="cv2"):
        V.image_load(str(tmp_path / "x.png"), backend="cv2")
