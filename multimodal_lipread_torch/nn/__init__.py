from multimodal_lipread_torch.nn.common import MLP, ClassifierHead, adaptive_avg_pool2d  # noqa: F401
from multimodal_lipread_torch.nn.recurrent import BiLSTM  # noqa: F401
