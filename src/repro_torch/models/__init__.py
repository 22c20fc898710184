"""The LM scaffold in PyTorch: layers, the Mamba mixer (over kernel B6),
MoE and the composable model (``transformer``)."""
