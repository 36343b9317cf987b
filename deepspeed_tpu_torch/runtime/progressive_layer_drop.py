"""Progressive Layer Drop (counterpart of
``deepspeed_tpu/runtime/progressive_layer_drop.py``): the keep probability
theta(t) = (1 - theta_0) exp(-gamma t) + theta_0 of step t, handed to the
model as ``layer_keep_prob`` (``models.layers.Block``'s residual gate).
"""

import numpy as np


class ProgressiveLayerDrop:
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        def _prob(x, gamma, p):
            return (1.0 - p) * np.exp(-gamma * x) + p
        self.current_theta = _prob(global_step, self.gamma, self.theta)
        return self.current_theta
