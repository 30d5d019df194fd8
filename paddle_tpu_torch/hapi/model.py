"""The high-level ``Model`` (counterpart of ``paddle_tpu/hapi/model.py``).

``prepare(..., use_jit=True)`` (the default) trains through the port's
``jit.TrainStep`` over the network (loss, backward, regularizer, clip and
update in one call, eagerly: the port has no compiled step);
``use_jit=False`` is the eager branch (``loss.backward()``,
``optimizer.step()``, ``optimizer.clear_grad()``). As in the reference,
the jit branch computes the metrics of a batch with a second, eval-mode
forward after the step.

Not ported, each raising ``NotImplementedError``: ``prepare(amp_configs=
...)`` (``ROADMAP.md`` A.13 (d), AMP) and ``save(path, training=False)``,
the inference export through ``jit.save`` (A.6 item 2). The reference's
mesh branch (``ShardedTrainStep`` under an active fleet mesh, A.10) has
no counterpart: the port's ``Model`` trains on one card.
"""
from __future__ import annotations

import os

import numpy as np

from .. import framework
from ..metric import Metric
from .callbacks import CallbackList


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics = []
        self._use_jit = True
        self._train_step = None
        self.stop_training = False

    # ------------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, use_jit=True):
        if amp_configs is not None:
            raise NotImplementedError(
                "Model.prepare(amp_configs=...): AMP is not ported yet "
                "(ROADMAP.md A.13 (d))")
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        self._metrics = list(self._metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError("metrics must be paddle_tpu.metric.Metric")
        self._use_jit = use_jit
        self._train_step = None

    # ------------------------------------------------------------------
    def _compute_loss(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        labs = labels if isinstance(labels, (list, tuple)) else [labels]
        if callable(self._loss):
            loss = self._loss(*(list(outs) + list(labs)))
        else:
            raise RuntimeError("prepare() with a loss before training")
        if isinstance(loss, (list, tuple)):
            loss = sum(loss[1:], loss[0])
        if loss.size != 1:
            loss = loss.mean()
        return loss

    def _split_batch(self, data):
        if isinstance(data, (list, tuple)):
            data = list(data)
        else:
            data = [data]
        n_in = len(self._inputs) if self._inputs else 1
        inputs = data[:n_in]
        labels = data[n_in:]
        return inputs, labels

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if labels is not None else []
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        if self._use_jit:
            if self._train_step is None:
                from ..jit import TrainStep

                n_inputs = len(inputs)

                def step_fn(*batch):
                    ins, labs = batch[:n_inputs], batch[n_inputs:]
                    outputs = self.network(*ins)
                    return self._compute_loss(outputs, labs)

                self._train_step = TrainStep(self.network, step_fn,
                                             self._optimizer)
            loss = self._train_step(*(list(inputs) + list(labels)))
            metrics_out = (self._eval_metrics_on_batch(inputs, labels)
                           if self._metrics else [])
            return [float(loss.item())] + metrics_out
        # eager path
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics_out = self._update_metrics(outputs, labels)
        return [float(loss.item())] + metrics_out

    def _eval_metrics_on_batch(self, inputs, labels):
        with framework.no_grad():
            self.network.eval()
            outputs = self.network(*inputs)
            self.network.train()
        return self._update_metrics(outputs, labels)

    def _update_metrics(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        res = []
        for m in self._metrics:
            computed = m.compute(*(list(outs) + list(labels)))
            r = m.update(computed)
            res.append(r)
        return res

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if labels is not None else []
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        with framework.no_grad():
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels) if self._loss else None
        metrics_out = self._update_metrics(outputs, labels)
        out = [float(loss.item())] if loss is not None else []
        return out + metrics_out

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        with framework.no_grad():
            out = self.network(*inputs)
        return out

    # ------------------------------------------------------------------
    def fit(
        self,
        train_data=None,
        eval_data=None,
        batch_size=1,
        epochs=1,
        eval_freq=1,
        log_freq=10,
        save_dir=None,
        save_freq=1,
        verbose=2,
        drop_last=False,
        shuffle=True,
        num_workers=0,
        callbacks=None,
        accumulate_grad_batches=1,
        num_iters=None,
    ):
        from ..io import DataLoader, Dataset

        if isinstance(train_data, Dataset):
            train_loader = DataLoader(
                train_data, batch_size=batch_size, shuffle=shuffle,
                drop_last=drop_last, num_workers=num_workers,
            )
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size)
        else:
            eval_loader = eval_data

        cbks = CallbackList(callbacks, model=self, verbose=verbose,
                            metrics=self._metrics_names(), log_freq=log_freq,
                            save_dir=save_dir, save_freq=save_freq)
        cbks.on_train_begin()
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, data in enumerate(train_loader):
                if num_iters is not None and step >= num_iters:
                    break
                cbks.on_train_batch_begin(step)
                inputs, labels = self._split_batch(data)
                outs = self.train_batch(inputs, labels)
                logs = self._make_logs(outs)
                logs["step"] = step
                logs["batch_size"] = (
                    inputs[0].shape[0] if hasattr(inputs[0], "shape") else batch_size
                )
                cbks.on_train_batch_end(step, logs)
            if self._optimizer is not None and self._optimizer._lr_scheduler is not None:
                self._optimizer._lr_scheduler.step()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
        cbks.on_train_end()

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2, num_workers=0, callbacks=None, num_iters=None):
        from ..io import DataLoader, Dataset

        if isinstance(eval_data, Dataset):
            loader = DataLoader(eval_data, batch_size=batch_size)
        else:
            loader = eval_data
        for m in self._metrics:
            m.reset()
        logs = {}
        losses = []
        for step, data in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            inputs, labels = self._split_batch(data)
            outs = self.eval_batch(inputs, labels)
            if self._loss:
                losses.append(outs[0])
            logs = self._make_logs(outs)
        if losses:
            logs["loss"] = float(np.mean(losses))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False, verbose=1, callbacks=None):
        from ..io import DataLoader, Dataset

        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size)
        else:
            loader = test_data
        outputs = []
        for data in loader:
            inputs, _ = self._split_batch(data)
            out = self.predict_batch(inputs)
            outputs.append(out)
        return outputs

    def _metrics_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _make_logs(self, outs):
        logs = {}
        names = self._metrics_names()
        i = 0
        if self._loss:
            logs["loss"] = outs[0]
            i = 1
        for m in self._metrics:
            r = m.accumulate()
            n = m.name()
            if isinstance(n, list):
                for nn, rr in zip(n, r if isinstance(r, list) else [r]):
                    logs[nn] = rr
            else:
                logs[n] = r
        return logs

    # ------------------------------------------------------------------
    def save(self, path, training=True):
        """``training=True``: the network's ``state_dict`` to
        ``path.pdparams`` and the optimizer's to ``path.pdopt``, through
        ``paddle.save``."""
        from .. import framework_io

        if not training:
            raise NotImplementedError(
                "Model.save(training=False) exports through jit.save, which "
                "is not ported yet (ROADMAP.md A.6 item 2)")
        framework_io.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            framework_io.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from .. import framework_io

        param_path = (path if path.endswith(".pdparams")
                      else path + ".pdparams")
        self.network.set_state_dict(framework_io.load(param_path))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(framework_io.load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def summary(net, input_size=None, dtypes=None, input=None):
    """paddle.summary — layer table + param counts."""
    rows = []
    total_params = 0
    trainable_params = 0
    for name, layer in net.named_sublayers(include_self=True):
        n_params = 0
        for p in layer.parameters(include_sublayers=False):
            n_params += p.size
            total_params += p.size
            if p.trainable:
                trainable_params += p.size
        rows.append((name or layer.__class__.__name__, layer.__class__.__name__, n_params))
    lines = ["-" * 64]
    lines.append(f"{'Layer (type)':<40}{'Params':>12}")
    lines.append("-" * 64)
    for name, cls, n in rows:
        lines.append(f"{name + ' (' + cls + ')':<40}{n:>12,}")
    lines.append("-" * 64)
    lines.append(f"Total params: {total_params:,}")
    lines.append(f"Trainable params: {trainable_params:,}")
    print("\n".join(lines))
    return {"total_params": total_params, "trainable_params": trainable_params}
