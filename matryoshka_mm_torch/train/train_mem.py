"""Training entry with flash attention: ``python -m
matryoshka_mm_torch.train.train_mem --model_name_or_path ...``."""

from .train import train

if __name__ == "__main__":
    train(attn_implementation="flash")
