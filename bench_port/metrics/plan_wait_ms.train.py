"""Mean time the training thread waited for the next planned batch from
`PlanPool.imap` (the benchmark's span `train.wait`), in ms a step."""


def read(ctx):
    w = ctx["spans"].get("train.wait")
    return 1e3 * sum(w) / len(w) if w else None
