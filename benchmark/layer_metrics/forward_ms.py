"""forward_ms: milliseconds a round of the device time of the kernels
launched inside the program's ``fed.forward`` ranges (one a station a
round, around ``loss_local`` in ``workloads/fed_transformer.py``), from
any thread: the model's forward and loss, attention's forward included,
over the traced rounds."""


def read(ctx):
    from portbench import spans

    return spans.per_round_ms(ctx, "fed.forward")
