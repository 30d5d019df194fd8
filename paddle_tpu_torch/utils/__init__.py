"""paddle.utils (counterpart of ``paddle_tpu/utils``): ``flags``,
``unique_name`` and the small helpers. The reference's ``download`` and
``cpp_extension`` are left out on purpose (no network; the XLA FFI has no
counterpart, ROADMAP)."""
from . import flags  # noqa: F401
from . import unique_name  # noqa: F401


def try_import(module_name, err_msg=None):
    import importlib

    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(err_msg or f"{module_name} is required but not "
                          "installed")


def run_check():
    """Run one small matmul on the current device and print it."""
    import paddle_tpu_torch as paddle

    x = paddle.ones([2, 2])
    y = paddle.matmul(x, x)
    if float(y.sum().item()) != 8.0:
        raise RuntimeError("paddle_tpu_torch: run_check's matmul is wrong")
    print(f"paddle_tpu_torch is installed successfully! device: "
          f"{paddle.get_device()}")


class deprecated:
    def __init__(self, update_to="", since="", reason="", level=0):
        pass

    def __call__(self, fn):
        return fn


def require_version(min_version, max_version=None):
    return True
