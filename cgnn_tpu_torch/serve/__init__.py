"""serve: see the package docstring of cgnn_tpu_torch. The device set
(``devices.py``) is exported here, as the JAX package's ``serve``
exports it; the server and its parts are imported from their modules."""

from cgnn_tpu_torch.serve.devices import (
    DeviceSet,
    replicate_state,
    resolve_devices,
)

__all__ = ["DeviceSet", "replicate_state", "resolve_devices"]
