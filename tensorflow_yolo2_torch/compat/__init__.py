"""Weight import from TensorFlow checkpoints: ``tf_bundle`` reads the
files in numpy alone, ``tf_import`` maps their names onto the port's
models."""

from tensorflow_yolo2_torch.compat.tf_bundle import (  # noqa: F401
    load_tf_checkpoint,
)
from tensorflow_yolo2_torch.compat.tf_import import (  # noqa: F401
    import_checkpoint_for,
    import_darknet19_checkpoint,
    import_resnet50_checkpoint,
    state_dict_for,
)
