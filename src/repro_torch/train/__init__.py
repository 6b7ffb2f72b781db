"""Training substrate: AdamW, schedules and step factories (counterpart of
``repro.train``)."""
from .optimizer import (AdamWState, OptConfig, apply_updates, global_norm,
                        init_state, schedule_lr)
from .steps import accumulate_grads, make_eval_step, make_train_step
