"""The port's own copy of the control plane's event types; the control plane
itself comes with the trainer slice."""
