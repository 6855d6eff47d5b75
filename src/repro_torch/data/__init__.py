"""data — synthetic MRI volumes."""
