"""decode_ms.serve: device milliseconds a batch of the kernels launched
inside apis.decode_detections (top-k, min-area rects, over-mask, scan)."""

WRAPS = [("orientedreppoints_tpu_torch.apis", "decode_detections", "decode",
          "span")]


def read(run):
    if not run.rec.spans.get("decode"):
        return None
    return 1e3 * run.view.device_s_under("decode") / run.steps
