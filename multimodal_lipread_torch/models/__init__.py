"""Model zoo of the port (so far the audio ``vgg_lstm``)."""
