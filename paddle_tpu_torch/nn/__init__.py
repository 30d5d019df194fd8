"""``paddle.nn`` of the surface (counterpart of ``paddle_tpu/nn``): ``Layer``,
the common, container, conv, pooling, norm, activation, loss and
transformer layers, the initializers and the functionals, beside the
gradient clips the optimizers take (``nn/clip.py``), the recurrent
layers (``nn/layer/rnn.py``) and the long tail (``nn/layer/compat.py``).
The torch-level modules the port's models build on stay at their paths:
``nn/norm.py`` and ``nn/functional/fused_cross_entropy.py``.
"""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_,
                   global_grad_norm, global_grad_sumsq)
from .layer.common import (  # noqa: F401
    AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity, Dropout,
    Dropout2D, Dropout3D, Embedding, Flatten, Fold, Identity, Linear, Pad1D,
    Pad2D, Pad3D, PixelShuffle, PixelUnshuffle, Unfold, Upsample,
    UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D)
from .layer.container import (LayerDict, LayerList,  # noqa: F401
                              ParameterList, Sequential)
from .layer.layers import Layer  # noqa: F401
from .layer.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    RReLU, SELU, Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign,
    Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .layer.conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose)
from .layer.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, GaussianNLLLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss,
    MarginRankingLoss, MSELoss, MultiLabelSoftMarginLoss, NLLLoss,
    PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss, TripletMarginLoss)
from .layer.pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, LPPool2D, MaxPool1D, MaxPool2D, MaxPool3D)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SyncBatchNorm)
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)
from .layer.rnn import (  # noqa: F401
    GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase, SimpleRNN,
    SimpleRNNCell)
from .layer.compat import (  # noqa: F401
    AdaptiveLogSoftmaxWithLoss, BeamSearchDecoder, FeatureAlphaDropout,
    FractionalMaxPool2D, FractionalMaxPool3D, HSigmoidLoss, LPPool1D,
    MaxUnPool1D, MaxUnPool2D, MaxUnPool3D, MultiMarginLoss, PairwiseDistance,
    ParameterDict, RNNTLoss, Softmax2D, SpectralNorm,
    TripletMarginWithDistanceLoss, Unflatten, ZeroPad1D, ZeroPad3D,
    dynamic_decode)
from ..param_attr import ParamAttr  # noqa: F401
from . import quant  # noqa: F401,E402
