"""server_update_ms: milliseconds a round of the server's step, the
program's ``server.update`` phase (the server optimizer on the aggregate
and ``apply_updates``: Adam for the transformer, ``sgd(1.0)`` for FedAvg),
read as ``aggregate_ms`` is."""


def read(ctx):
    from portbench import spans

    return spans.per_round_ms(ctx, "server.update")
