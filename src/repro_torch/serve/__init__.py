"""Serving of the port: the padded-batch engine and its step functions."""

from .engine import Request, ServeEngine
from .serve_step import (greedy_sample, make_decode_step, make_prefill_step,
                         temperature_sample)
