"""prepare_ms.serve: host wall milliseconds a batch inside
serving.Predictor.prepare (resize, normalize and paste of the batch)."""

WRAPS = [("orientedreppoints_tpu_torch.serving", "Predictor.prepare",
          "prepare", "span")]


def read(run):
    spans = run.rec.spans.get("prepare")
    return 1e3 * sum(spans) / run.steps if spans else None
