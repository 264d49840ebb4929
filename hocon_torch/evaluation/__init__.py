"""Evaluation, ported from ``hocon.evaluation``: keypoint and vertex error
meters, and the HO-3D CodaLab submission dump."""

from hocon_torch.evaluation.codalab import dump_ho3d_codalab
from hocon_torch.evaluation.zimeval import EvalUtil, VertexErrorMeter
