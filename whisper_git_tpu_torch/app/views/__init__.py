"""View composers (L5): pure `state -> El` functions, one module per pane
(reference: src/commit_graph.rs, sidebar.rs, staging.rs, diff_view.rs,
commit_details.rs, dialogs.rs, welcome.rs)."""
