"""``paddle.Model``, its callbacks and ``paddle.metric`` of the port against
the JAX package on the CPU.

- LeNet through ``Model.fit`` in both packages on the same seeded
  weights and the same unshuffled batches of the separable FakeMNIST
  (``tests/test_hapi_lenet.py``'s): every step's loss to 1e-4 relative
  over 2 epochs, then ``evaluate`` (loss to 1e-4, accuracy equal) and
  ``predict`` (to 1e-4 of the largest logit);
- the metrics on the same arrays: equal results;
- the callbacks driven in both packages over the same logs: the same
  decisions (EarlyStopping's stop, ReduceLROnPlateau's learning rates),
  and ``ModelCheckpoint``/``LRScheduler`` in a port ``fit``;
- ``Model.save``/``load`` and ``summary``'s counts, and the branches the
  port does not have.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from test_torch_conv_pool import fast_jax_init, seeded  # noqa: F401
from test_torch_threads import one_intra_op_thread  # noqa: F401

LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def fake_mnist(p, n, seed=0):
    """``tests/test_hapi_lenet.py``'s separable digits as a ``p.io``
    Dataset."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, (n,))
    images = np.zeros((n, 1, 28, 28), np.float32)
    for i, lab in enumerate(labels):
        images[i, 0, lab * 2:lab * 2 + 4, :] = 1.0
        images[i] += rng.randn(1, 28, 28).astype(np.float32) * 0.05

    class FakeMNIST(p.io.Dataset):
        def __getitem__(self, idx):
            return images[idx], np.int64(labels[idx])

        def __len__(self):
            return n

    return FakeMNIST()


def _record(p):
    class Record(p.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))

    return Record()


def test_lenet_fit_like_jax(fast_jax_init):
    nets = {p: p.vision.models.LeNet(num_classes=10) for p in (jp, tp)}
    seeded(nets[jp], nets[tp], seed=3)
    got = {}
    for p, net in nets.items():
        model = p.Model(net)
        model.prepare(p.optimizer.Adam(learning_rate=1e-3,
                                       parameters=net.parameters()),
                      p.nn.CrossEntropyLoss(), p.metric.Accuracy())
        rec = _record(p)
        model.fit(p.io.DataLoader(fake_mnist(p, 96), batch_size=32),
                  epochs=2, verbose=0, callbacks=[rec])
        held = p.io.DataLoader(fake_mnist(p, 64, seed=1), batch_size=32)
        res = model.evaluate(held, verbose=0)
        preds = model.predict(held)
        got[p] = (rec.losses, res, np.concatenate(
            [np.asarray((o[0] if isinstance(o, (list, tuple)) else o).numpy())
             for o in preds]))
    (jl, jres, jpred), (tl, tres, tpred) = got[jp], got[tp]
    assert len(tl) == len(jl) == 6
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=LOSS_RTOL)
    assert tres["acc"] == jres["acc"]
    assert tpred.shape == jpred.shape == (64, 10)
    np.testing.assert_allclose(tpred, jpred, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * np.abs(jpred).max())


def test_eager_branch_matches_the_train_step():
    """``use_jit=False`` (backward, step, clear_grad) and the default
    ``TrainStep`` branch take the same steps."""
    losses = []
    for use_jit in (True, False):
        tp.seed(4)
        net = tp.vision.models.LeNet()
        model = tp.Model(net)
        model.prepare(tp.optimizer.Adam(learning_rate=1e-3,
                                        parameters=net.parameters()),
                      tp.nn.CrossEntropyLoss(), use_jit=use_jit)
        data = tp.io.DataLoader(fake_mnist(tp, 64), batch_size=32)
        losses.append([model.train_batch([x], [y])[0]
                       for _ in range(2) for x, y in data])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


# -- metrics ---------------------------------------------------------------------
def _metric_run(p):
    rng = np.random.RandomState(7)
    pred = rng.rand(12, 5).astype(np.float32)
    label = rng.randint(0, 5, (12, 1)).astype(np.int64)
    prob = rng.rand(12).astype(np.float32)
    binary = (rng.rand(12) > 0.5).astype(np.int64)
    out = []
    acc = p.metric.Accuracy(topk=(1, 3))
    for lo in (0, 6):
        c = acc.compute(p.to_tensor(pred[lo:lo + 6]),
                        p.to_tensor(label[lo:lo + 6]))
        out.append(acc.update(c))
    out += [acc.accumulate(), acc.name()]
    for cls in ("Precision", "Recall", "Auc"):
        m = getattr(p.metric, cls)()
        for lo in (0, 6):
            m.update(p.to_tensor(prob[lo:lo + 6]),
                     p.to_tensor(binary[lo:lo + 6]))
        out += [m.accumulate(), m.name()]
        m.reset()
        out.append(m.accumulate())
    out.append(float(p.metric.accuracy(p.to_tensor(pred), p.to_tensor(label),
                                       k=2)))
    return out


def test_metrics_like_jax():
    got, want = _metric_run(tp), _metric_run(jp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str) or isinstance(w, list) and w and \
                isinstance(w[0], str):
            assert g == w
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=1e-7)
    assert tp.metric.accuracy(tp.to_tensor(np.eye(3, dtype=np.float32)),
                              tp.to_tensor(np.arange(3))).dtype == tp.float32


# -- callbacks -------------------------------------------------------------------
class _StubOpt:
    def __init__(self, lr):
        self.lr = lr
        self._lr_scheduler = None

    def get_lr(self):
        return self.lr

    def set_lr(self, lr):
        self.lr = lr


class _StubModel:
    def __init__(self):
        self.stop_training = False
        self._optimizer = _StubOpt(0.1)


def _drive(p, make, values, key):
    model = _StubModel()
    cb = make(p.callbacks)
    cb.set_model(model)
    trace = []
    for epoch, v in enumerate(values):
        cb.on_epoch_end(epoch, {key: v})
        trace.append((model.stop_training, model._optimizer.lr))
    return trace


@pytest.mark.parametrize("make,key,values", [
    (lambda c: c.EarlyStopping("loss", patience=2), "loss",
     [1.0, 0.9, 0.95, 0.91, 0.92, 0.5]),
    (lambda c: c.EarlyStopping("acc", patience=1, min_delta=0.05), "acc",
     [0.5, 0.6, 0.62, 0.7]),
    (lambda c: c.ReduceLROnPlateau("loss", factor=0.5, patience=1,
                                   cooldown=1, verbose=0), "loss",
     [1.0, 1.0, 1.0, 0.5, 0.6, 0.7, 0.8]),
    (lambda c: c.ReduceLROnPlateau("acc", factor=0.1, patience=2,
                                   min_lr=0.002, verbose=0), "acc",
     [0.1, 0.1, 0.1, 0.1, 0.1, 0.1]),
])
def test_callbacks_decide_like_jax(make, key, values):
    assert _drive(tp, make, values, key) == _drive(jp, make, values, key)


def test_checkpoint_and_lr_scheduler_in_fit(tmp_path):
    tp.seed(5)
    net = tp.vision.models.LeNet()
    sched = tp.optimizer.lr.StepDecay(learning_rate=0.01, step_size=2,
                                      gamma=0.5)
    model = tp.Model(net)
    model.prepare(tp.optimizer.Adam(learning_rate=sched,
                                    parameters=net.parameters()),
                  tp.nn.CrossEntropyLoss())
    rec = _record(tp)
    model.fit(tp.io.DataLoader(fake_mnist(tp, 64), batch_size=32), epochs=2,
              verbose=0, save_dir=str(tmp_path), save_freq=1,
              callbacks=[rec, tp.callbacks.LRScheduler(by_step=True)])
    # 4 batches stepped by the callback and 2 epoch ends by fit
    assert sched.last_epoch == 6
    assert model._optimizer.get_lr() == pytest.approx(0.01 * 0.5 ** 3)
    for name in ("0", "1", "final"):
        assert (tmp_path / f"{name}.pdparams").exists()
        assert (tmp_path / f"{name}.pdopt").exists()
    tp.seed(6)
    other = tp.Model(tp.vision.models.LeNet())
    other.prepare(tp.optimizer.Adam(learning_rate=1e-3,
                                    parameters=other.network.parameters()))
    other.load(str(tmp_path / "final"))
    for (k, a), (_, b) in zip(net.state_dict().items(),
                              other.network.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert other._optimizer.state_dict()["@step"] == 4


def test_save_load_summary_and_missing_branches(tmp_path, capsys):
    tp.seed(7)
    model = tp.Model(tp.vision.models.LeNet())
    model.prepare(tp.optimizer.SGD(learning_rate=0.1,
                                   parameters=model.parameters()),
                  tp.nn.CrossEntropyLoss())
    model.save(str(tmp_path / "m"))
    saved = {k: v.numpy() for k, v in model.network.state_dict().items()}
    x = tp.randn([4, 1, 28, 28])
    model.train_batch([x], [tp.to_tensor(np.arange(4))])
    model.load(str(tmp_path / "m"))
    for k, v in model.network.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved[k], err_msg=k)
    counts = model.summary()
    assert counts == jp.summary(jp.vision.models.LeNet()) == {
        "total_params": 61610, "trainable_params": 61610}
    assert "Total params: 61,610" in capsys.readouterr().out
    # training=False writes the jit.save artifact over the network's last
    # call ([4, 1, 28, 28]); a CPU Predictor serves it as Model.predict
    model.save(str(tmp_path / "infer"), training=False)
    from paddle_tpu_torch.inference import Config, create_predictor

    cfg = Config(str(tmp_path / "infer"))
    cfg.disable_gpu()
    got = create_predictor(cfg).run([x])[0]
    want = model.predict(tp.io.TensorDataset([x]), batch_size=4)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    with pytest.raises(NotImplementedError, match="never reads it"):
        model.prepare(amp_configs={"level": "O1"})
