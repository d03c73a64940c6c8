"""dispatch_host_ms: milliseconds a round the host spends in the fused
runner's dispatch, the program's ``fedavg.dispatch`` ranges around
``FedAvg.run_rounds``: signature checks, placing the inputs, copying them
into the graph's buffers, the replay's launch and copying the results
out. A host time taken under the profiler, which slows the host's every
call, so it reads above the same dispatch untraced."""


def read(ctx):
    from portbench import spans

    seconds = spans.host_seconds(ctx.trace, "fedavg.dispatch")
    if seconds is None or ctx.trace.rounds <= 0:
        return None
    return 1e3 * seconds / ctx.trace.rounds
