"""forward_ms.serve: device milliseconds a batch of the kernels launched
inside the detector's forward (backbone, FPN, head with the DCN)."""

WRAPS = [("orientedreppoints_tpu_torch.models.detector",
          "OrientedRepPointsDetector.forward", "forward", "span")]


def read(run):
    if not run.rec.spans.get("forward"):
        return None
    return 1e3 * run.view.device_s_under("forward") / run.steps
