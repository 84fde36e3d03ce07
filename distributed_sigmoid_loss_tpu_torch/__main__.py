"""``python -m distributed_sigmoid_loss_tpu_torch <train|eval|tokenizer> ...``"""

import sys

from distributed_sigmoid_loss_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
