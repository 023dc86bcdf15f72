"""Model zoo of the port: the audio ``vgg_lstm`` and the seven video models."""
