from .infer import ClipInferenceEngine, InferRequest, pick_bucket  # noqa: F401
from .optim import build_optimizer, param_group_label  # noqa: F401
from .train import TrainStep, make_train_step  # noqa: F401
