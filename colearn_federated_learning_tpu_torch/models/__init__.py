"""Model families (BERT so far) and their registry."""
