"""``paddle.fft`` over ``torch.fft`` (counterpart of ``paddle_tpu/fft.py``).

The Hermitian 2-D and n-D transforms are the reference's compositions:
``hfft2``/``hfftn`` are ``irfft2``/``irfftn`` of the conjugate under the
inverse norm, ``ihfft2``/``ihfftn`` the conjugate of ``rfft2``/``rfftn``.

Where the reference departs from Paddle's documented signatures the port
takes Paddle's: ``axes`` is an int or a sequence of ints, the transforms
take ``name`` (the reference's take ``name_``), and ``fftfreq``/``rfftfreq``
return ``dtype`` (the default float type when it is None; the reference
never reads it).
"""
from __future__ import annotations

import torch

from .core.dispatch import apply_op
from .core.tensor import Tensor

__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2",
           "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn", "hfft2",
           "ihfft2", "hfftn", "ihfftn", "fftfreq", "rfftfreq", "fftshift",
           "ifftshift"]


def _mk1(name):
    tfn = getattr(torch.fft, name)

    def op(x, n=None, axis=-1, norm="backward", name=None):
        return apply_op(lambda a: tfn(a, n=n, dim=axis, norm=norm), x,
                        _op_name=name)

    op.__name__ = name
    return op


def _mkn(name, default_axes):
    tfn = getattr(torch.fft, name)

    def op(x, s=None, axes=default_axes, norm="backward", name=None):
        dim = _dims(axes)
        return apply_op(lambda a: tfn(a, s=s, dim=dim, norm=norm), x,
                        _op_name=name)

    op.__name__ = name
    return op


fft = _mk1("fft")
ifft = _mk1("ifft")
rfft = _mk1("rfft")
irfft = _mk1("irfft")
hfft = _mk1("hfft")
ihfft = _mk1("ihfft")
fft2 = _mkn("fft2", (-2, -1))
ifft2 = _mkn("ifft2", (-2, -1))
rfft2 = _mkn("rfft2", (-2, -1))
irfft2 = _mkn("irfft2", (-2, -1))
fftn = _mkn("fftn", None)
ifftn = _mkn("ifftn", None)
rfftn = _mkn("rfftn", None)
irfftn = _mkn("irfftn", None)


def _inv(norm):
    return {"backward": "forward", "forward": "backward"}.get(norm, norm)


def _dims(axes):
    """``axes`` (None, an int, or a sequence of ints) as torch's ``dim``."""
    if axes is None:
        return None
    if isinstance(axes, int):
        return (axes,)
    return tuple(int(a) for a in axes)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return apply_op(lambda a: torch.fft.irfft2(a.conj(), s=s, dim=_dims(axes),
                                               norm=_inv(norm)),
                    x, _op_name="hfft2")


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return apply_op(lambda a: torch.fft.rfft2(a, s=s, dim=_dims(axes),
                                              norm=_inv(norm)).conj(),
                    x, _op_name="ihfft2")


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.irfftn(a.conj(), s=s, dim=_dims(axes),
                                               norm=_inv(norm)),
                    x, _op_name="hfftn")


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    return apply_op(lambda a: torch.fft.rfftn(a, s=s, dim=_dims(axes),
                                              norm=_inv(norm)).conj(),
                    x, _op_name="ihfftn")


def _freq(tfn, n, d, dtype):
    from . import dtypes, framework
    from .device import _current_device

    dt = dtypes.to_torch(dtype or framework.get_default_dtype())
    return Tensor._wrap(tfn(n, d, dtype=dt, device=_current_device()))


def fftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)


def fftshift(x, axes=None, name=None):
    return apply_op(lambda a: torch.fft.fftshift(a, dim=_dims(axes)), x,
                    _op_name="fftshift")


def ifftshift(x, axes=None, name=None):
    return apply_op(lambda a: torch.fft.ifftshift(a, dim=_dims(axes)), x,
                    _op_name="ifftshift")
