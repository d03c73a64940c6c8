"""aggregate_ms: milliseconds a round of the aggregation, the program's
``fed.aggregate`` phase (the masked, weighted means of the updates and of
the loss, or the sharded update's reduce-scatter): the device time of the
kernels launched inside its ranges where the round is eager
(``workloads/fed_transformer.py``), the timing events the program kept
for each traced replay where it is replayed (``fed/fedavg.py``)."""


def read(ctx):
    from portbench import spans

    return spans.per_round_ms(ctx, "fed.aggregate")
