"""The training step: render -> loss -> gradients -> Adam; the grid step
over K independent cells."""
