"""Training of the port: AdamW, the synthetic data stream, the train step
(remat, int8 error-feedback gradient compression) and checkpoints."""
