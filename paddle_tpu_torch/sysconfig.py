"""paddle.sysconfig (counterpart of ``paddle_tpu/sysconfig.py``): the
build paths for extension authors. The port's kernels build from
``ops/kernels/csrc``, so ``get_include`` names that directory and
``get_lib`` the directory the built libraries land in."""
import os

__all__ = ["get_include", "get_lib"]

_PKG = os.path.dirname(os.path.abspath(__file__))


def get_include() -> str:
    return os.path.join(_PKG, "ops", "kernels", "csrc")


def get_lib() -> str:
    from .ops.kernels import BUILD_DIR

    return str(BUILD_DIR)
