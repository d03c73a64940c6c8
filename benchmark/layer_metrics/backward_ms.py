"""backward_ms: milliseconds a round of the device time of the kernels
launched inside the program's ``fed.backward`` ranges (one a station a
round, around ``torch.autograd.grad`` in ``workloads/fed_transformer.py``).
Autograd launches them from its own thread, so a launch counts by its
time, on any thread (``portbench/spans.py``)."""


def read(ctx):
    from portbench import spans

    return spans.per_round_ms(ctx, "fed.backward")
