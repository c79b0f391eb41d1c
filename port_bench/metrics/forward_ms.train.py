"""forward_ms.train: device milliseconds a step of the kernels launched
inside the detector's train-mode forward (the backward is not in it)."""

WRAPS = [("orientedreppoints_tpu_torch.models.detector",
          "OrientedRepPointsDetector.forward", "forward", "span")]


def read(run):
    if not run.rec.spans.get("forward"):
        return None
    return 1e3 * run.view.device_s_under("forward") / run.steps
