from multimodal_lipread_torch.models.backbones.mobilenet import MobileNetV2, MobileNetV3Small  # noqa: F401
from multimodal_lipread_torch.models.backbones.resnet import ResNet  # noqa: F401
from multimodal_lipread_torch.models.backbones.shufflenet import ShuffleNetV2  # noqa: F401
from multimodal_lipread_torch.models.backbones.vgg import VGG  # noqa: F401
