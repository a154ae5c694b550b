"""Training of the port: losses, optimizer, the MKD train step and the eval
step, metrics, checkpoints and the Trainer."""
