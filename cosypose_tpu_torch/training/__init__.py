from .pose_training import (
    PoseTrainConfig,
    TrainState,
    make_optimizer,
    pose_loss,
    make_train_step,
    make_val_step,
    create_train_state,
)
