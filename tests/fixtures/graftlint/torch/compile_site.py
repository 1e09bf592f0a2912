"""Compiling side of the cross-module TRACE001 pair
(``torch.compile(functools.partial(imported_fn, spec))``)."""

import functools

import torch

from compile_defs import body_fn

stepper = torch.compile(functools.partial(body_fn, 2))
