"""Training: AdamW (``optim``), the train step (``step``), checkpoints
(``checkpoint``) and the host data pipeline (``data``)."""
