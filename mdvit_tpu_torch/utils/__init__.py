"""Config containers, running averages and the scalar log of the trainer."""
