"""The checker service: a long-lived server that owns the card and
answers check requests and streamed histories from many clients, and its
client.  The port's counterpart of the JAX package's ``service/``, queue
family."""

from jepsen_tpu_torch.service.client import (  # noqa: F401
    CheckerClient,
    RetryPolicy,
    ServiceUnavailable,
)
from jepsen_tpu_torch.service.server import CheckerServer  # noqa: F401
