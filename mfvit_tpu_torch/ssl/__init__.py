"""Self-supervised pretraining (MoCo)."""
