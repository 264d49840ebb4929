"""Device ms a step of the trunk's convolutions, forward and backward: the
device time of the kernels launched under ``aten::cudnn_convolution`` and
``aten::convolution_backward`` in the traced steps."""

LAYER = "model"
UNIT = "ms/step"
MOVES = "step_ms"


def read(s: dict):
    return s["conv_ms"]
