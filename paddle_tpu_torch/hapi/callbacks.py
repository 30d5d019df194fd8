"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``).

``VisualDL`` appends its scalars to ``{log_dir}/scalars.jsonl`` (the
visualdl package is not a dependency); ``WandbCallback`` imports wandb
when it is made and raises without it unless ``anonymous_ok``.
"""
from __future__ import annotations

import numbers
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._start = time.time()
        self._samples = 0

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        logs = logs or {}
        self._samples += logs.get("batch_size", 0)
        if self.verbose and step % self.log_freq == 0:
            items = []
            for k, v in logs.items():
                if k in ("step", "batch_size"):
                    continue
                if isinstance(v, numbers.Number):
                    items.append(f"{k}: {v:.4f}")
            elapsed = max(time.time() - self._start, 1e-9)
            ips = self._samples / elapsed
            print(f"Epoch {self.epoch} step {step}: " + ", ".join(items) + f" | {ips:.1f} samples/sec")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            logs = logs or {}
            items = [
                f"{k}: {v:.4f}" for k, v in logs.items()
                if isinstance(v, numbers.Number) and k not in ("step", "batch_size")
            ]
            print(f"Epoch {epoch} end: " + ", ".join(items))


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            import os

            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            import os

            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1, min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.best = None
        self.wait = 0
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        v = logs.get(self.monitor)
        if v is None:
            return
        improved = (
            self.best is None
            or (self.mode == "min" and v < self.best - self.min_delta)
            or (self.mode == "max" and v > self.best + self.min_delta)
        )
        if improved:
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def on_train_batch_end(self, step, logs=None):
        if self.by_step and self.model and self.model._optimizer:
            sched = self.model._optimizer._lr_scheduler
            if sched is not None:
                sched.step()


class CallbackList:
    def __init__(self, callbacks=None, model=None, **params):
        self.callbacks = list(callbacks or [])
        verbose = params.get("verbose", 2)
        if not any(isinstance(c, ProgBarLogger) for c in self.callbacks) and verbose:
            self.callbacks.insert(0, ProgBarLogger(params.get("log_freq", 10), verbose))
        if params.get("save_dir") and not any(isinstance(c, ModelCheckpoint) for c in self.callbacks):
            self.callbacks.append(ModelCheckpoint(params.get("save_freq", 1), params.get("save_dir")))
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_train_begin(self, logs=None):
        self._call("on_train_begin", logs)

    def on_train_end(self, logs=None):
        self._call("on_train_end", logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_train_batch_begin(self, step, logs=None):
        self._call("on_train_batch_begin", step, logs)

    def on_train_batch_end(self, step, logs=None):
        self._call("on_train_batch_end", step, logs)


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer lr when a monitored metric stops improving."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "auto":
            # same inference rule as EarlyStopping above: loss-like metrics
            # minimize, everything else (acc/f1/precision/auc...) maximizes
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode
        self.best = float("-inf") if mode == "max" else float("inf")
        self.wait = 0
        self.cooldown_counter = 0

    def _better(self, cur):
        if self.mode == "max":
            return cur > self.best + self.min_delta
        return cur < self.best - self.min_delta

    def _metric(self, logs):
        v = (logs or {}).get(self.monitor)
        if isinstance(v, (list, tuple)):
            v = v[0]
        return v

    def _step(self, logs):
        cur = self._metric(logs)
        if cur is None:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._better(float(cur)):
            self.best = float(cur)
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    new_lr = max(float(opt.get_lr()) * self.factor,
                                 self.min_lr)
                    opt.set_lr(new_lr)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr -> {new_lr:.3e}")
                self.cooldown_counter = self.cooldown
                self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        # epoch-end only: eval metrics land in the epoch logs, and hooking
        # on_eval_end too would double-count an epoch against `patience`
        self._step(logs)


class VisualDL(Callback):
    """Scalar logger: the scalars of each epoch (and of each eval) append
    to ``{log_dir}/scalars.jsonl``, one JSON record a line."""

    def __init__(self, log_dir="vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def _write(self, tag, logs):
        import json
        import os

        os.makedirs(self.log_dir, exist_ok=True)
        rec = {}
        for k, v in (logs or {}).items():
            if isinstance(v, (int, float)):
                rec[k] = v
            elif isinstance(v, (list, tuple)) and v and \
                    isinstance(v[0], (int, float)):
                rec[k] = v[0]
        # the cumulative counter orders records across epochs; a per-epoch
        # logs["step"] (last batch index) must not clobber it
        rec["step"] = self._step
        rec["tag"] = tag
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1

    def on_epoch_end(self, epoch, logs=None):
        self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)


class WandbCallback(Callback):
    """Weights & Biases logger. Without the wandb package this callback
    raises at construction (the reference's hard dependency) unless
    ``anonymous_ok``, which makes it a no-op."""

    def __init__(self, project=None, anonymous_ok=False, **kwargs):
        super().__init__()
        try:
            import wandb  # noqa: F401
        except ImportError:
            if not anonymous_ok:
                raise ImportError(
                    "WandbCallback requires the wandb package; pass "
                    "anonymous_ok=True to no-op, or use the VisualDL "
                    "callback's jsonl scalars")
            self._wandb = None
        else:
            import wandb

            self._wandb = wandb.init(project=project, **kwargs)

    def on_epoch_end(self, epoch, logs=None):
        if self._wandb is not None:
            self._wandb.log(dict(logs or {}, epoch=epoch))
