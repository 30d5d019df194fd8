"""paddle.version (counterpart of ``paddle_tpu/version.py``): the
reference's fields, with the CUDA and cuDNN versions of the torch build
this package runs on (cuDNN's is read when asked for: reading it loads
the library)."""
import torch

full_version = "3.0.0-cuda"
major = "3"
minor = "0"
patch = "0"
rc = "0"
istaged = True
commit = "torch-port"
with_mkl = "OFF"
cuda_version = str(torch.version.cuda) if torch.version.cuda else "False"
xpu_version = "False"


def show():
    print(f"full_version: {full_version}")
    print(f"commit: {commit}")
    print(f"cuda: {cuda_version}")
    print(f"cudnn: {cudnn()}")


def cuda():
    return cuda_version


def cudnn():
    return (str(torch.backends.cudnn.version())
            if torch.backends.cudnn.is_available() else "False")


def __getattr__(name):
    if name == "cudnn_version":
        return cudnn()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def xpu():
    return False


def nccl():
    return torch.cuda.nccl.version() if torch.cuda.is_available() else False
