"""The benchmark's plain reference: plain PyTorch and NumPy that imports
nothing of the program under test. It decodes the benchmark's WAV files
itself, computes the log-mel, the two models' forward passes, the loss and
Adam from the weights and inputs the benchmark made, and is what the
program's outputs are judged against."""
