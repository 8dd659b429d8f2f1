"""Loop closing: candidate verification, correction and the host-side detector."""
