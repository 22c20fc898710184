"""Training substrate of the port's LM scaffold: optimizers,
checkpointing and the trainer loop."""
