# Training: AdamW (optim.py), int8 gradient compression (compress.py) and
# the train / serve step factories (step.py).
from .optim import AdamWConfig, AdamWState, apply_updates, init_state
from .step import make_serve_steps, make_train_step

__all__ = ["AdamWConfig", "AdamWState", "init_state", "apply_updates",
           "make_train_step", "make_serve_steps"]
