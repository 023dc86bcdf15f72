"""Offline tools (the WAV mirror, the cue sanitizer) and studies of the
port's kernels that run on the CPU."""
