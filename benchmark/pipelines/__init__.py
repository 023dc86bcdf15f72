"""How the benchmark drives one pipeline of the program: one module per
pipeline, named by a configuration's ``pipeline`` key. Each builds the
program's trainer and dataset, or its resident predictor and request
function, the way the pipeline's own entry point does, and says which
clips a batch of the program holds."""
