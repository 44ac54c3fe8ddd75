from robogym_torch.viewer.replay import EnvReplayViewer, render_trajectory  # noqa: F401
