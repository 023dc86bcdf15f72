from multimodal_lipread_torch.models.backbones.vgg import VGG  # noqa: F401
