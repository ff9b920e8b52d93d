"""Per-batch times of the clm Timer's spans in the traced run's Timer-on
phase."""


def per_batch_ms(ctx, keys):
    """The spans `keys` summed, in ms a Timer-on batch; None where none ran."""
    sums = ctx["timer"]["sums"]
    if not ctx["timer_batches"] or not any(k in sums for k in keys):
        return None
    return sum(sums.get(k, 0.0) for k in keys) / ctx["timer_batches"] * 1e3
