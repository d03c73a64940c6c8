"""local_train_ms: milliseconds a round of the stations' local training,
the program's ``fed.local_train`` phase (the batched local SGD steps in
``fed/fedavg.py::_round_impl``). In a replayed round it is the span of the
phase's timing events in the graph, as the program kept them for each
traced replay, averaged over the replays; in an eager round, the device
time of the kernels launched inside its ranges."""


def read(ctx):
    from portbench import spans

    return spans.per_round_ms(ctx, "fed.local_train")
