"""Volume rendering: the eval renderer and the fused eval MLP."""
