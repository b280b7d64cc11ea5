"""Training: workload configs, the train/eval steps and ``Trainer``, the
checkpoint format and manager, the model-zoo registry and the CLI
(``python -m satellite_computervision_tpu_torch.train``)."""
