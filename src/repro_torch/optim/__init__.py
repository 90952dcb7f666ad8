"""The optimizer of the port: AdamW and the cosine schedule (the port of
`repro.optim`)."""

from .adamw import adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule
