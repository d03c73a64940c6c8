"""compress_ms: milliseconds a round of the compression of the stations'
deltas with error feedback, the program's ``fed.compress`` phase
(``_compress_deltas`` in ``fed/fedavg.py``), read as ``local_train_ms``
is: the replays' timing events, or the eager ranges' device time."""


def read(ctx):
    from portbench import spans

    return spans.per_round_ms(ctx, "fed.compress")
