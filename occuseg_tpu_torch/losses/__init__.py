from occuseg_tpu_torch.losses.instance import (  # noqa: F401
    LossConfig,
    classification_loss,
    discriminative_loss,
    occuseg_total_loss,
    semantic_cross_entropy,
)
