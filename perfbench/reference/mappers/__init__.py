"""One module per mapper family, named by the configuration's
`mapper.model_type` and found by that name (`reference.models.family`).

Each defines `spec(m, clip_dim, channels)`, the family's tensors in its
published key names ({key: (shape, (kind, std))}, in the order the weights
are drawn), and `forward(sd, x, m, channels, P=EXACT)`, (B, clip_dim +
noise_dim) -> (B, S, S, channels), every product through `P.q`. Like the
rest of reference/, a family imports nothing of the program.
"""
