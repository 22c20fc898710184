"""Entry points of the port's LM scaffold (``serve``), and the SpMV cost
terms (``costmodel``) and weight-update rule (``hillclimb``) that the
heterogeneous engine splits its work by."""
