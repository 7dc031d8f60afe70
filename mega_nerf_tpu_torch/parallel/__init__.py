"""The training step: render -> loss -> gradients -> Adam."""
