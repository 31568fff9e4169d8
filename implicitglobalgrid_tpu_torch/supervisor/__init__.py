"""Run supervision of the port: for now only generation fencing
(`generation`).  The supervisor itself (relaunch policy, classify, the
fleet tier) is ROADMAP Queue A item 14e."""
