"""Training: the optimizers (AdamW, Adafactor), the train step with
gradient accumulation, the straggler watchdog, and the int8 quantization
(the serving path's compressed residency, and the error-feedback
all-reduce of data parallelism)."""
