"""Tensors on a device that no kernel wrapper takes, for the tests that
hold the wrappers to raising there."""

import torch


class Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device other than the CPU, a card or
    meta."""

    @property
    def device(self):
        return torch.device("xpu", 0)


def elsewhere(*shape):
    return torch.empty(*shape).as_subclass(Elsewhere)
