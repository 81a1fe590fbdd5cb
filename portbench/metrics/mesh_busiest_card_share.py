"""The busiest card's share of the cards' device time over the window:
the largest `device_s_by_card` over their sum, in % (25 is an even split
over four cards, 100 one card doing everything)."""


def read(ctx):
    s = ctx.get("trace")
    if s is None or not s["device_s_by_card"]:
        return None
    by_card = s["device_s_by_card"]
    total = sum(by_card.values())
    if total <= 0.0:
        return None
    return 100.0 * max(by_card.values()) / total
