"""Station axis on one GPU."""
