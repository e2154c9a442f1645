"""Training of the port (counterpart of `mico_tpu/train/`): token masking,
the LR schedules, the VAST task objectives, the param-group AdamW and the
train step, on one card or data-parallel across processes (`axis_name`,
`zero1`)."""
