"""Model families (MLP, CNN, ResNet-18, TCN, ViT, BERT, MoE-BERT), their
flax-numerics layers and their registry."""
