from multimodal_lipread_torch.nn.common import (  # noqa: F401
    MLP,
    BatchNorm,
    ClassifierHead,
    Dropout,
    adaptive_avg_pool2d,
    flax_init_,
)
from multimodal_lipread_torch.nn.recurrent import LSTM, BiLSTM, LSTMLayer  # noqa: F401
