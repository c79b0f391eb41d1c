"""losses_ms.train: host wall milliseconds a step inside
parallel.train.compute_losses (assigners, APAA, the losses' forward)."""

WRAPS = [("orientedreppoints_tpu_torch.parallel.train", "compute_losses",
          "losses", "span")]


def read(run):
    spans = run.rec.spans.get("losses")
    return 1e3 * sum(spans) / run.steps if spans else None
